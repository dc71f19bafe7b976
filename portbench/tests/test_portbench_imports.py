"""No module that the benchmark loads is the JAX stack or the JAX
package (compared by whole top-level name: the port's own name begins
with the JAX package's)."""

import subprocess
import sys
import textwrap

from portbench import harness

DRIVE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import portbench.run, portbench.calibrate, portbench.check
    import portbench.trace, portbench.roofline
    from portbench import harness
    from portbench.tests.portbench_tiny import run_tiny, workloads
    bench = harness.spec()
    for m in bench["end_to_end"]:
        harness.reader("end_to_end", m["name"])
    for m in bench["per_layer"]:
        harness.reader("layer_metrics", m["name"])
    for w in workloads():
        run_tiny(w, limits={{"disp_gap_px": 1.0}}, seconds=0.2)
    print(sorted({{m.split(".")[0] for m in sys.modules}}))
    print("FORBIDDEN", harness.forbidden_modules())
""")


def test_nothing_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c",
                          DRIVE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = out.stdout.strip().splitlines()[-2]
    for name in harness.FORBIDDEN:
        assert f"'{name}'" not in tops
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
    # the port itself was loaded: the check saw the program under test
    assert "'densematchingbenchmark_tpu_torch'" in tops


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("densematchingbenchmark_tpu_torch_probe", sys)
    try:
        assert "densematchingbenchmark_tpu_torch_probe" not in \
            harness.forbidden_modules()
    finally:
        sys.modules.pop("densematchingbenchmark_tpu_torch_probe")
