"""Depth from a stream of stereo frames, one at a time, as a robot or a
car consumes it: ``apis.inference_stereo(model, [pair],
pad_to_shape=...)`` on a model from ``apis.init_model``, one client in a
closed loop, each call timed from the call to the disparities on the
host.

The frames come from a pool of ``pool`` decoded uint8 pairs in host
memory, taken in an order drawn from the seed. What the timed path
produced is kept for the check: the three disparity maps of ``check``
calls drawn from the seed among the first ``check_within``, and of the
window's last call.
"""

import time

import torch


def prepare(ctx):
    from densematchingbenchmark_tpu_torch.apis import inference_stereo
    t = ctx.traffic
    model, weights = ctx.init_model()
    ctx.mark("model")
    scenes = ctx.scenes(t["pool"])
    ctx.mark("data")
    rng = ctx.rng(3)
    order = rng.permutation(len(scenes))
    wanted = set(int(v) for v in rng.choice(
        t["check_within"], t["check"], replace=False))
    ctx.tracer.attach(model.module)
    state = {"ctx": ctx, "model": model, "module": model.module,
             "weights": weights, "scenes": scenes, "order": order,
             "wanted": wanted, "kept": {}, "pad": tuple(t["pad_to"]),
             "infer": inference_stereo}
    for i in range(t.get("warmup_calls", 2)):
        _call(state, i)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.mark("warm-up")
    return state


def _call(state, k):
    s = state["scenes"][state["order"][k % len(state["order"])]]
    out = state["infer"](state["model"], [{"leftImage": s["left"],
                                           "rightImage": s["right"]}],
                         pad_to_shape=state["pad"])
    return out[0]["disps"]


def window(state, seconds, tracer):
    latencies = []
    last = None
    tracer.begin()
    t0 = time.perf_counter()
    while True:
        k = len(latencies)
        start = time.perf_counter()
        disps = _call(state, k)
        latencies.append(time.perf_counter() - start)
        tracer.tick(1, True)
        if k in state["wanted"]:
            state["kept"][k] = disps
        last = (k, disps)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    state["kept"][last[0]] = last[1]
    return {"frames": len(latencies), "calls": len(latencies),
            "elapsed_s": elapsed, "latencies_s": latencies,
            "attempted": len(latencies), "failed": 0}


def outputs(state):
    """[{'disps': [three [H, W] maps], 'left', 'right'}] of the kept
    calls; frees the program's state."""
    frames = []
    for k in sorted(state["kept"]):
        s = state["scenes"][state["order"][k % len(state["order"])]]
        frames.append({"disps": [torch.from_numpy(d[0, ..., 0])
                                 for d in state["kept"][k]],
                       "left": s["left"], "right": s["right"]})
    for k in ("model", "module", "infer"):
        state.pop(k, None)
    return frames
