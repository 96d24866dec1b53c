"""Multi-process distributed execution (SURVEY §7.8 / BASELINE "N>=2
hosts"): two OS processes, each with 2 CPU devices, form a global 4-device
mesh via jax.distributed.initialize; ShardedMacauEngine must produce the
SAME factors as the single-process engine at 1e-8.

This is the localhost stand-in for multi-host clusters — it catches
global-vs-addressable device bugs (sharded device_put, collective launch
order) that a single-process virtual mesh structurally cannot.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("variant", ["dense_int8", "headsplit_dual"])
def test_two_process_matches_single(tmp_path, variant):
    port = _free_port()
    out = str(tmp_path / "mp.npz")
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    repo_root = os.path.dirname(os.path.dirname(worker))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), out, variant],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=repo_root)
        for pid in range(2)]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode())
    for pid, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{text[-4000:]}"
    assert os.path.exists(out), outputs[0][-2000:]
    z = np.load(out)

    # single-process reference on the SAME problem/config/sweep count
    from tests import _mp_worker
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.utils.rng import sweep_key
    import jax
    rd = _mp_worker.build_problem(variant)
    cfg = _mp_worker.config(variant)
    eng = MacauEngine(rd, cfg)
    key = jax.random.key(cfg.seed)
    st = eng.init_state(jax.random.fold_in(key, 0))
    for s in range(_mp_worker.N_SWEEPS):
        st, metrics = eng._sweep_jit(eng.problem.arrays, st,
                                     sweep_key(key, s + 1), 1.0)
    for ei in range(len(rd.entities)):
        np.testing.assert_allclose(
            z[f"U{ei}"], np.asarray(st["ent"][ei]["U"]),
            rtol=1e-8, atol=1e-8,
            err_msg=f"2-process factors diverged (entity {ei})")
    np.testing.assert_allclose(float(z["rmse"]),
                               float(metrics["r0.rmse_sample"]), rtol=1e-8)
