"""The float32 floor under the data-parallel tests' bounds, on the CPU (a
script, not a test):

    python tests/parallel_noise_study.py [--cli]

For each family of tests/torch_parallel_ranks.py, one process's train
step at the global batch against (a) the same step from weights scaled by
(1 + 1e-7 N(0, 1)), four draws, and (b) the same step with the BatchNorm
statistics taken in one pass, E[x^2] - E[x]^2 (Flax's form), in place of
the two-pass form: the largest gradient difference over the largest
gradient, and the gradient norm's relative difference. These bound what
two ranks, whose float32 sums run in another order, can be held to
(tests/test_torch_parallel_train.py's GRAD_TOL).

``--cli`` also runs tools/train.main on StereoNet 8x 2-stage (float32,
64x128, 2 steps, a synthetic eval of 4; tests/test_torch_parallel.py's
run) in one process at 1, 2, 3 and 4 threads and prints the spread of
its last loss and eval EPEs: the one process's own float32 noise after
RMSprop's first update.
"""

import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_parallel_ranks as ranks  # noqa: E402
from densematchingbenchmark_tpu_torch.models import layers  # noqa: E402


def one_pass_batch_norm(self, x):
    """Flax's one-pass statistics in one process (the group's code path
    with no group: ``global_sum`` is the identity)."""
    c = x.shape[1]
    dims = [0, *range(2, x.dim())]
    shape = (1, c) + (1,) * (x.dim() - 2)
    mean = x.mean(dims)
    var = (x.square().mean(dims) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + self.eps) * self.weight
    y = (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
    with torch.no_grad():
        self.running_mean.lerp_(mean.detach(), self.momentum)
        self.running_var.lerp_(var.detach(), self.momentum)
        self.num_batches_tracked += 1
    return y


def step(family, perturb_seed=None):
    cfg, module, variables = ranks.family_model(family)
    if perturb_seed is not None:
        g = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in module.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    with mock.patch.object(ranks, "family_model",
                           lambda f, seed=0: (cfg, module, variables)):
        return ranks.train_step(family)


def compare(a, b):
    top = max(float(g.abs().max()) for g in a["grads"].values())
    err = max(float((a["grads"][k] - b["grads"][k]).abs().max())
              for k in a["grads"]) / top
    norm = abs(a["metrics"]["grad_norm"] / b["metrics"]["grad_norm"] - 1)
    return err, norm


def cli_spread():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for threads in (1, 2, 3, 4):
        with tempfile.TemporaryDirectory() as work:
            subprocess.run(
                [sys.executable, "-m",
                 "densematchingbenchmark_tpu_torch.tools.train",
                 "--config", "StereoNet/scene_flow_8x_2stage", "--cpu",
                 "--synthetic", "--synthetic-shape", "64", "128",
                 "--synthetic-length", "8", "--max-steps", "2",
                 "--synthetic-eval", "4", "--log-interval", "1",
                 "--work-dir", work, "--override", "model.dtype=float32",
                 "data.batch_size_per_device=2"],
                cwd=root, check=True, capture_output=True,
                env={**os.environ, "OMP_NUM_THREADS": str(threads),
                     "PYTHONPATH": root})
            with open(os.path.join(work, "metrics.log.json")) as fp:
                records = [json.loads(line) for line in fp if line.strip()]
        last = [r for r in records if "train/loss" in r][-1]
        evals = [r for r in records if "eval/disp_0/epe" in r][-1]
        out[threads] = {"loss": last["train/loss"],
                        **{k: v for k, v in evals.items() if k.endswith("epe")}}
    for key in out[1]:
        vals = [out[t][key] for t in out]
        print(f"StereoNet tools.train, {key} at 1-4 threads: "
              f"{[round(v, 5) for v in vals]}, spread "
              f"{(max(vals) - min(vals)) / min(vals):.3g} relative")


def main():
    torch.set_num_threads(1)
    for family in ranks.FAMILIES:
        ref = step(family)
        floors = [compare(ref, step(family, s)) for s in (1, 2, 3, 4)]
        real = layers.BatchNorm.forward

        def forward(self, x):
            if not self.training:
                return real(self, x)
            return one_pass_batch_norm(self, x.float()).to(x.dtype)
        with mock.patch.object(layers.BatchNorm, "forward", forward):
            one_pass = compare(ref, step(family))
        print(f"{family}: 1e-7 weight perturbations: gradient error "
              f"{max(e for e, _ in floors):.3g} of the largest (worst of "
              f"4), grad norm {max(n for _, n in floors):.3g}; one-pass BN "
              f"statistics: {one_pass[0]:.3g}, {one_pass[1]:.3g}")
    if "--cli" in sys.argv[1:]:
        cli_spread()


if __name__ == "__main__":
    main()
