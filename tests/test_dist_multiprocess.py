"""REAL multi-process exercise of parallel/dist.py (SURVEY §5.8):
two localhost CPU processes under jax.distributed encode GOP spans and
gather payloads over the process-level allgather (the DCN path); the
stitched stream must be byte-identical to a single-process encode.

This is the only way to execute dist.py's nproc>1 branch in CI — the
in-process tests cover only the single-process early return.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("gop_len", [1, 2])
def test_two_process_encode_matches_single(tmp_path, gop_len):
    port = _free_port()
    out = tmp_path / "proc0.264"
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            H264_COORD_ADDR=f"127.0.0.1:{port}",
            H264_NUM_PROCS="2",
            H264_PROC_ID=str(pid),
        )
        env.pop("XLA_FLAGS", None)  # 1 CPU device per process
        env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
            "PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "dist_worker.py"), str(out),
             str(gop_len)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
        assert p.returncode == 0, f"worker failed:\n{stdout[-2000:]}"

    # single-process reference (same content/config, this process)
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(HERE))
    from dist_worker import content
    from h264_fer.parallel.gop_device import GopIntraEncoder, GopIpppEncoder

    frames = content(64, 32, 5)
    if gop_len <= 1:
        enc = GopIntraEncoder(64, 32, 30, devices=jax.devices("cpu")[:1])
    else:
        enc = GopIpppEncoder(64, 32, 30, gop_len=gop_len,
                             devices=jax.devices("cpu")[:1])
    want = enc.encode_sequence(frames)
    got = out.read_bytes()
    assert got == want, (
        f"2-process stream ({len(got)}B) != single-process ({len(want)}B)")
