"""Run calls of the JAX package in a process whose XLA keeps every bf16
rounding the JAX code writes.

XLA on the CPU may keep a bf16 intermediate in fp32 (excess precision).
Where a bf16 state meets mult3, that changes the JAX package's result on up
to half of the outputs by a bf16 ulp, so the tests hold the port against
the JAX package run with ``--xla_allow_excess_precision=false``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_RUNNER = r"""
import importlib, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
import tensorfft_tpu as tfft
out = []
for call in json.loads(sys.stdin.read()):
    mod, name = call["fn"].rsplit(".", 1)
    fn = getattr(importlib.import_module(mod), name)
    args = [jnp.asarray(np.array(a, np.float32), call["dtype"])
            for a in call["args"]]
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in call["kwargs"].items()}
    if "plan" in call:
        kw["plan"] = tfft.create_plan(**call["plan"])
    res = fn(*args, **kw)
    res = res if isinstance(res, (tuple, list)) else [res]
    out.append([np.asarray(r, np.float32).tolist() for r in res])
print(json.dumps(out))
"""


def _jsonable(v):
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return v.value if hasattr(v, "value") else v


def call(fn, args, dtype, plan=None, **kwargs):
    """One call: ``fn`` as 'module.function' of the JAX package, its array
    arguments (numpy-convertible) in ``dtype`` ('bfloat16' or 'float32'),
    an optional ``plan`` as ``create_plan`` keywords, and static kwargs."""
    c = {"fn": fn, "dtype": dtype,
         "args": [np.asarray(a, np.float32).tolist() for a in args],
         "kwargs": {k: _jsonable(v) for k, v in kwargs.items()}}
    if plan is not None:
        c["plan"] = {k: _jsonable(v) for k, v in plan.items()}
    return c


def run(calls):
    """Each call's outputs, as lists of fp32 numpy arrays."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(root),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _RUNNER],
                          input=json.dumps(calls), capture_output=True,
                          text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    return [[np.array(r, np.float32) for r in res]
            for res in json.loads(proc.stdout.splitlines()[-1])]
