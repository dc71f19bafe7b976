"""Train state: the module (parameters and BN statistics), the optimizer
state, the step count and an explicit random generator.

Counterpart of densematchingbenchmark_tpu/trainer/state.py. JAX threads an
immutable pytree through a jitted step; here the module and the optimizer
update their tensors in place and the state object holds them.
``state_dict`` / ``load_state_dict`` are what utils/checkpoint.py saves.
"""

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    module: torch.nn.Module
    optimizer: object
    step: int
    generator: torch.Generator

    @classmethod
    def create(cls, module, optimizer, seed):
        return cls(module, optimizer, 0,
                   torch.Generator().manual_seed(seed))

    def state_dict(self):
        return {"module": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "generator": self.generator.get_state()}

    def load_state_dict(self, state):
        self.module.load_state_dict(state["module"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
