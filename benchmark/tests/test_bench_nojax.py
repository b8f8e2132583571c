"""Nothing the benchmark runs imports JAX or the JAX package.

Module names are compared by their top-level part, whole: the port's own
name, ``gol_distributed_final_tpu_torch``, begins with the JAX package's.
"""

import json
import subprocess
import sys
import time

from benchmark.harness import manifest, nojax, runner

PROBE = """
import runpy, sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
runpy.run_path({run!r}, run_name="benchmark_run")
from benchmark.harness import manifest, broker_child, faults, runner, check, devtrace
from gol_distributed_final_tpu_torch.engine import controller
from gol_distributed_final_tpu_torch.rpc import broker, client
for name in {drivers!r}:
    manifest.driver(name)
for name in {metrics!r}:
    manifest.reader(name)
for name in {checks!r}:
    manifest.check(name)
print(sorted(sys.modules))
"""


def test_the_harness_loads_no_jax(root):
    drivers = sorted(p.stem for p in (manifest.BENCH / "traffic").glob("*.py"))
    metrics = sorted(p.name[:-3] for p in (manifest.BENCH / "metrics").glob("*.py"))
    checks = sorted(p.stem for p in (manifest.BENCH / "checks").glob("*.py"))
    assert "sessions_closed" in drivers and "cell_updates_per_s" in metrics and "window" in checks
    code = PROBE.format(root=str(root), run=str(root / "benchmark" / "run.py"),
                        drivers=drivers, metrics=metrics, checks=checks)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    modules = eval(out.strip().splitlines()[-1])
    assert "gol_distributed_final_tpu_torch.rpc.broker" in modules
    assert nojax.loaded(modules) == []


def test_names_are_compared_whole():
    assert nojax.loaded(["gol_distributed_final_tpu_torch", "gol_distributed_final_tpu_torch.x",
                         "jaxtyping", "flaxen"]) == []
    assert nojax.loaded(["jax.numpy", "jaxlib", "flax", "gol_distributed_final_tpu.ops"]) == [
        "flax", "gol_distributed_final_tpu.ops", "jax.numpy", "jaxlib"]


def test_a_run_whose_broker_loads_jax_is_refused(capsys, cpu_cell, tmpdir_env):
    """The broker child runs the port: JAX loaded there in the window (here
    a stub, put in its ``sys.modules`` by its first reply) refuses the run."""
    rc = runner.main(["--workload", cpu_cell, "--seed", "2147483661",
                      "--seconds", "1"], t_start=time.monotonic(), device="cpu",
                     fault="loads_jax")
    out, err = capsys.readouterr()
    assert rc == runner.EXIT_JAX and out == ""
    assert "the broker loaded jax" in err
    assert "this process loaded" not in err

