"""Nothing a benchmark run loads may be JAX or the JAX package: the check
compares top-level module names whole, since the port's name begins with
the JAX package's."""

import json
import os
import subprocess
import sys

from bench_helpers import HERE, ROOT
from harness import guard


def test_names_compare_whole():
    assert guard.forbidden_loaded(["montecarlo_tpu_torch",
                                   "montecarlo_tpu_torch.ops.fused_sweep",
                                   "jaxtyping", "flaxen", "numpy"]) == []
    assert guard.forbidden_loaded(["montecarlo_tpu", "montecarlo_tpu.ops",
                                   "jax", "jax.numpy", "jaxlib.xla_client",
                                   "flax.linen"]) == sorted(
        ["montecarlo_tpu", "montecarlo_tpu.ops", "jax", "jax.numpy",
         "jaxlib.xla_client", "flax.linen"])
    assert guard.top_level("montecarlo_tpu_torch.core") == \
        "montecarlo_tpu_torch"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    # a fresh process: drive one small cell of each configuration and
    # every per-layer reader, then list what it holds
    code = f"""
import json, os, sys
sys.path[:0] = [{HERE!r}, {ROOT!r}, {os.path.join(HERE, 'tests')!r}]
import bench_helpers
from harness import spec
for w in spec.benchmark()["workloads"]:
    bench_helpers.run_small(w["name"])
for m in spec.benchmark()["per_layer"]:
    spec.module("layer_metrics", m["name"])
for f in os.listdir(os.path.join({HERE!r}, "counts")):
    if f.endswith(".py"):
        spec.module("counts", f[:-3])
print(json.dumps(sorted(sys.modules)))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "montecarlo_tpu_torch" in modules
    assert guard.forbidden_loaded(modules) == []
