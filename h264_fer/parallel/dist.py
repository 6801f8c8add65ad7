"""Multi-host distribution skeleton (SURVEY §5.8, BASELINE config 5).

JAX is single-controller-per-process on multi-host clusters: each host process calls
``jax.distributed.initialize`` and then sees the global device set;
in-program collectives ride the device links within a host and the network
across hosts. For
this codec the natural cross-host axis is the GOP axis — IDR-delimited
GOPs are fully independent (the encoder zeroes MV state at IDR), so the
multi-host topology is: every process encodes its contiguous span of
GOPs with the single-host device encoders (parallel/gop_device.py /
parallel/tile.py over its LOCAL devices), and the ordered Annex-B
concatenation happens once at process 0 (the only stage that touches
DCN, and it moves only the compressed payloads).

The reference has no distribution of any kind; its closest analog is the
one-frame-at-a-time session loop (fer_h264.cpp:81-134). This module is
the env-gated entry point plus the host-side GOP scatter/gather; it is
exercised single-process in CI (init is a no-op without the env) and is
the intended surface for a real multi-host deployment.

Env contract (mirrors jax.distributed's own):
  H264_COORD_ADDR   coordinator "host:port" — presence enables init
  H264_NUM_PROCS    total process count
  H264_PROC_ID      this process's index (0-based)
"""

from __future__ import annotations

import os

import numpy as np


def maybe_init_distributed() -> tuple[int, int]:
    """Initialize jax.distributed from the env if configured.

    Returns (process_index, process_count); (0, 1) when not configured —
    single-process operation is the no-env default, so CI and single-host
    runs need no setup.
    """
    addr = os.environ.get("H264_COORD_ADDR")
    if not addr:
        return 0, 1
    import jax

    n = int(os.environ.get("H264_NUM_PROCS", "1"))
    pid = int(os.environ.get("H264_PROC_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=n, process_id=pid)
    return jax.process_index(), jax.process_count()


def gop_spans(n_frames: int, gop_len: int, n_procs: int):
    """Per-process contiguous GOP spans: (start_frame, end_frame) per
    process, balanced by GOP count. GOPs are the distribution unit so
    every span starts on an IDR and no prediction state crosses spans."""
    n_gops = -(-n_frames // gop_len)
    base, rem = divmod(n_gops, n_procs)
    spans = []
    g0 = 0
    for p in range(n_procs):
        g1 = g0 + base + (1 if p < rem else 0)
        spans.append((min(g0 * gop_len, n_frames),
                      min(g1 * gop_len, n_frames)))
        g0 = g1
    return spans


def encode_multihost(frames, width: int, height: int, qp: int,
                     gop_len: int = 1, mode: str = "i16") -> bytes | None:
    """Encode `frames` with GOPs sharded across processes.

    Every process encodes its span with the local-device GOP encoder;
    process 0 gathers the byte payloads over DCN (jax process-level
    allgather of length-prefixed buffers) and returns the stitched
    stream; other processes return None. Single-process: equivalent to
    the plain sequence encode.
    """
    import jax

    from .gop_device import GopIntraEncoder, GopIpppEncoder

    pid, nproc = jax.process_index(), jax.process_count()
    spans = gop_spans(len(frames), gop_len if gop_len > 1 else 1, nproc)
    lo, hi = spans[pid]
    if gop_len <= 1:
        # idr_pic_id runs globally across the process spans (the serial
        # encoder's consecutive-IDR counter, encoder._encode_slice)
        enc = GopIntraEncoder(width, height, qp, mode=mode,
                              devices=jax.local_devices())
        local = (enc.encode_sequence(frames[lo:hi], idr_base=lo)
                 if hi > lo else b"")
    else:
        enc = GopIpppEncoder(width, height, qp, gop_len=gop_len,
                             devices=jax.local_devices())
        local = enc.encode_sequence(frames[lo:hi]) if hi > lo else b""
    # strip the SPS/PPS header from every process's stream; process 0
    # re-emits it once at the front
    hdr = enc.headers()
    body = local[len(hdr):] if local else b""
    if nproc == 1:
        return hdr + body
    # DCN gather: fixed-width length-prefixed byte tensors via the
    # process-level allgather (multihost_utils), ordered by process id
    from jax.experimental import multihost_utils

    maxlen = int(multihost_utils.process_allgather(
        np.asarray(len(body), np.int64)).max())
    buf = np.zeros(maxlen, np.uint8)
    buf[: len(body)] = np.frombuffer(body, np.uint8)
    lens = multihost_utils.process_allgather(np.asarray(len(body), np.int64))
    bufs = multihost_utils.process_allgather(buf)
    if pid != 0:
        return None
    out = bytearray(hdr)
    for p in range(nproc):
        out += bytes(np.asarray(bufs[p][: int(lens[p])], np.uint8))
    return bytes(out)
