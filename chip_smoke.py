"""Smoke run of the encoder's device paths on an NVIDIA GPU.

Drives the encoder's main paths at 1080p (1920x1088) through the normal
entry points, checks every stream byte for byte against its oracle and
every decoded frame against the encoder's reconstruction, compares each
device stage with the CPU backend bit for bit, and prints compile
seconds, warm seconds, memory figures and the card's name and power
limit. Every check raises on failure; the last line of standard output,
a JSON object naming the device, is printed only when all phases passed.

    python chip_smoke.py              # phases a-e on one card
    python chip_smoke.py --cards 4    # the sharded paths on four cards

Phases (one card):
  a  all-intra I16 through the CLI: --gop-devices 1 vs the serial
     --device-iframe i16 encode, decoded through the CLI
  b  mixed-mode (I4x4-vs-I16) all-intra: GopIntraEncoder vs serial
  c  IPPP, GOP 8, through the CLI: --gop-devices 1 vs the serial
     --device-iframe --device-pframe encode
  d  GPU vs CPU backend streams at 640x352 (i16, mixed, deblock, IPPP)
  e  every device stage at 1080p on the GPU vs the CPU backend

The phases' checks run at once, so their compiles overlap; their warm
timings then run one after another, each with the card to itself. It
exits non-zero, without printing a result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

W, H, QP = 1920, 1088, 28
PARITY_W, PARITY_H = 640, 352  # the reference thesis's IPPP geometry


def log(msg: str) -> None:
    print(msg, flush=True)


def content(n: int, w: int, h: int, seed: int = 7):
    """Structured frames from a seed: gradients + texture that move by
    a few pixels per frame (realistic CAVLC and motion-search load)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = (((xx // 7 + yy // 5 + 3 * i) % 200)
             + rng.integers(0, 12, (h, w))).astype(np.uint8)
        cb = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
        cr = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _write_y4m(path: str, frames) -> None:
    from h264_fer.vio.y4m import Y4MWriter

    h, w = frames[0][0].shape
    wtr = Y4MWriter(path, w, h, 24, 1)
    for f in frames:
        wtr.write_frame(*f)
    wtr.close()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _cli_encode(src: str, out: str, *opts: str) -> bytes:
    from h264_fer import cli

    rc = cli.main(["encode", src, out, "--qp", str(QP), *opts])
    if rc != 0:
        raise RuntimeError(f"cli encode {opts} exited {rc}")
    return _read(out)


def _serial(frames, intra_every: int, iframe, pframe: bool = False,
            scene_cut: bool = True):
    """Serial device-path encoder: stream plus every frame's
    reconstruction (the decode oracle)."""
    from h264_fer.codec.encoder import Encoder, EncoderConfig
    from h264_fer.codec.device_intra import DeviceIntraPipeline

    h, w = frames[0][0].shape
    enc = Encoder(w, h, EncoderConfig(qp=QP, intra_every=intra_every,
                                      scene_cut_idr=scene_cut),
                  device_pipeline=DeviceIntraPipeline(w, h, qp=QP),
                  device_iframe=iframe, device_pframe=pframe)
    stream = bytearray(enc.headers())
    recons = []
    for f in frames:
        stream += enc.encode_frame(*f)
        recons.append(tuple(np.copy(p) for p in enc.reconstructed()))
    return bytes(stream), recons


def _check_decode(stream: bytes, recons, tmp: str, label: str) -> None:
    """Decode through the CLI; every frame must equal the encoder's
    reconstruction."""
    from h264_fer import cli
    from h264_fer.vio.y4m import Y4MReader

    src = os.path.join(tmp, f"{label}.264")
    out = os.path.join(tmp, f"{label}_dec.y4m")
    with open(src, "wb") as f:
        f.write(stream)
    if cli.main(["decode", src, out]) != 0:
        raise RuntimeError(f"{label}: cli decode failed")
    got = list(Y4MReader(out))
    if len(got) != len(recons):
        raise AssertionError(
            f"{label}: decoded {len(got)} frames, encoded {len(recons)}")
    for i, (g, r) in enumerate(zip(got, recons)):
        for k, name in enumerate(("y", "cb", "cr")):
            if not np.array_equal(g[k], r[k]):
                raise AssertionError(f"{label}: frame {i} {name} differs "
                                     "from the encoder's reconstruction")


def _same(label: str, a: bytes, b: bytes) -> None:
    if a != b:
        raise AssertionError(f"{label}: streams differ ({len(a)} vs "
                             f"{len(b)} bytes)")


def _compiled(label: str, build):
    """Run build() (a compile that returns a jax.stages.Compiled), print
    its seconds and memory analysis, and return the executable."""
    compiled, dt = _timed(build)
    ma = compiled.memory_analysis()
    mem = ("memory_analysis unavailable" if ma is None else
           f"args {ma.argument_size_in_bytes} B, "
           f"out {ma.output_size_in_bytes} B, "
           f"temp {ma.temp_size_in_bytes} B, "
           f"code {ma.generated_code_size_in_bytes} B")
    log(f"  {label}: compile {dt:.2f} s; {mem}")
    return compiled


def _peak(dev) -> str:
    stats = dev.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "peak_bytes_in_use not reported"
    return f"peak_bytes_in_use {stats['peak_bytes_in_use']} B"


def _warm(label: str, fn, n_frames: int, reps: int = 3) -> float:
    """Median wall seconds per frame of fn() over reps (fn reads its
    results back to the host, which ends each run)."""
    vals = sorted(_timed(fn)[1] for _ in range(reps))
    per = vals[len(vals) // 2] / n_frames
    log(f"  {label}: warm {per:.4f} s/frame (median of {reps} runs of "
        f"{n_frames} frames)")
    return per


def _both(f, g):
    """f() and g() in two threads; returns both results and re-raises
    either's exception."""
    with ThreadPoolExecutor(2) as pool:
        a, b = pool.submit(f), pool.submit(g)
        return a.result(), b.result()


def phase_a(dev, w: int = W, h: int = H, n: int = 8):
    """All-intra I16 through the CLI (one device), byte parity with the
    serial path, CLI decode equal to the serial reconstructions. Returns
    the warm timing, to be run once the card is otherwise idle."""
    from h264_fer.parallel.gop_device import GopIntraEncoder

    log(f"[a] all-intra I16 {w}x{h}, {n} frames, CLI --gop-devices 1")
    frames = content(n, w, h)
    enc = GopIntraEncoder(w, h, QP, devices=[dev])
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        _write_y4m(src, frames)

        def gop_side():
            _compiled(f"[a] GopIntraEncoder i16 {w}x{h}",
                      lambda: enc.compile(n))
            return _timed(_cli_encode, src, os.path.join(tmp, "g.264"),
                          "--gop-devices", "1", "--intra-every", "1")

        def serial_side():
            cli = _timed(_cli_encode, src, os.path.join(tmp, "s.264"),
                         "--intra-every", "1", "--device-iframe", "i16")
            return cli, _serial(frames, 1, True)

        (gop, t_gop), ((ser, t_ser), (ser_py, recons)) = _both(
            gop_side, serial_side)
        log(f"  [a] first CLI encodes: gop {t_gop:.2f} s, serial "
            f"{t_ser:.2f} s")
        _same("a: gop vs serial CLI", gop, ser)
        _same("a: serial CLI vs serial encoder", ser, ser_py)
        _check_decode(gop, recons, tmp, "a")
    return lambda: _warm("[a] GopIntraEncoder i16",
                         lambda: enc.encode_sequence(frames), n)


def phase_b(dev, w: int = W, h: int = H, n: int = 4):
    """Mixed-mode all-intra: GopIntraEncoder vs the serial mixed path,
    decode equal to the serial reconstructions. Returns the warm
    timing."""
    from h264_fer.parallel.gop_device import GopIntraEncoder

    log(f"[b] all-intra mixed {w}x{h}, {n} frames, GopIntraEncoder")
    frames = content(n, w, h, seed=11)
    enc = GopIntraEncoder(w, h, QP, mode="mixed", devices=[dev])

    def gop_side():
        _compiled(f"[b] GopIntraEncoder mixed {w}x{h}",
                  lambda: enc.compile(n))
        return _timed(enc.encode_sequence, frames)

    (gop, t_gop), (ser, recons) = _both(
        gop_side, lambda: _serial(frames, 1, "mixed"))
    log(f"  [b] first encode {t_gop:.2f} s")
    _same("b: gop vs serial mixed", gop, ser)
    with tempfile.TemporaryDirectory() as tmp:
        _check_decode(gop, recons, tmp, "b")
    return lambda: _warm("[b] GopIntraEncoder mixed",
                         lambda: enc.encode_sequence(frames), n)


def phase_c(dev, w: int = W, h: int = H, n: int = 8, gop: int = 8):
    """IPPP through the CLI (one device, fixed GOPs) vs the serial
    device I+P path, decode equal to the serial reconstructions. Returns
    the warm timing."""
    from h264_fer.parallel.gop_device import GopIpppEncoder

    log(f"[c] IPPP {w}x{h}, GOP {gop}, {n} frames, CLI --gop-devices 1")
    frames = content(n, w, h, seed=5)
    enc = GopIpppEncoder(w, h, QP, gop_len=gop, devices=[dev])
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        _write_y4m(src, frames)

        def gop_side():
            _compiled(f"[c] GopIpppEncoder {w}x{h} GOP {gop}",
                      lambda: enc.compile(n))
            return _timed(_cli_encode, src, os.path.join(tmp, "g.264"),
                          "--gop-devices", "1", "--intra-every", str(gop),
                          "--no-scene-cut")

        def serial_side():
            cli = _timed(_cli_encode, src, os.path.join(tmp, "s.264"),
                         "--intra-every", str(gop), "--no-scene-cut",
                         "--device-iframe", "--device-pframe")
            return cli, _serial(frames, gop, True, pframe=True,
                                scene_cut=False)

        (g, t_gop), ((s, t_ser), (ser_py, recons)) = _both(
            gop_side, serial_side)
        log(f"  [c] first CLI encodes: gop {t_gop:.2f} s, serial "
            f"{t_ser:.2f} s")
        _same("c: gop vs serial CLI", g, s)
        _same("c: serial CLI vs serial encoder", s, ser_py)
        _check_decode(g, recons, tmp, "c")
    return lambda: _warm("[c] GopIpppEncoder",
                         lambda: enc.encode_sequence(frames), n)


def phase_d(dev, ref_dev, w: int = PARITY_W, h: int = PARITY_H,
            n_intra: int = 2, n_ippp: int = 8, gop: int = 4):
    """The same sequence encoders on dev and on ref_dev (the CPU
    backend on the chip) must emit identical streams. All encodes run
    at once. No warm timing: returns None."""
    from h264_fer.parallel.gop_device import (
        GopIntraEncoder,
        GopIpppEncoder,
    )

    log(f"[d] {dev.platform} vs {ref_dev.platform} streams at {w}x{h}")
    frames = content(max(n_intra, n_ippp), w, h, seed=3)
    cases = [
        ("GopIntraEncoder i16", GopIntraEncoder, frames[:n_intra], {}),
        ("GopIntraEncoder mixed", GopIntraEncoder, frames[:n_intra],
         {"mode": "mixed"}),
        ("GopIntraEncoder i16 deblock", GopIntraEncoder, frames[:n_intra],
         {"deblock": True}),
        (f"GopIpppEncoder GOP {gop}", GopIpppEncoder, frames[:n_ippp],
         {"gop_len": gop}),
    ]
    with ThreadPoolExecutor(2 * len(cases)) as pool:
        futs = [[pool.submit(_timed, cls(w, h, QP, devices=[d], **kw)
                             .encode_sequence, fr) for d in (dev, ref_dev)]
                for _, cls, fr, kw in cases]
        for (label, *_), (f_dev, f_ref) in zip(cases, futs):
            (got, t), (want, t_ref) = f_dev.result(), f_ref.result()
            _same(f"d: {label}", got, want)
            log(f"  [d] {label}: {len(got)} bytes identical "
                f"({dev.platform} {t:.2f} s, {ref_dev.platform} "
                f"{t_ref:.2f} s, compile included)")
    return None


def _stage_inputs(w: int, h: int, ref_dev):
    """Per-stage inputs at w x h, computed once on ref_dev (numpy)."""
    import jax

    from h264_fer.codec.device_intra import intra_mode_decision
    from h264_fer.codec.device_pframe import (
        _mbq_to_blocks,
        adaptive_maxdiff,
        me_params,
        pframe_maps,
    )
    from h264_fer.kernels.wavefront import wavefront_i16_frame
    from h264_fer.kernels.wavefront_p import pframe_decide
    from h264_fer.ops import transform
    from h264_fer.ops.interp import interpolated_planes_jax, pad_chroma_jax
    from h264_fer.ops.intra import INTRA16_TO_CHROMA_MODE

    wmb, hmb = w // 16, h // 16
    window = 8
    ext = window + 2
    qpc = transform.chroma_qp(QP, 0)
    (y0, cb0, cr0), (y1, _, _) = content(2, w, h, seed=9)
    put = functools.partial(jax.device_put, device=ref_dev)
    y, cb, cr = (put(p.astype(np.int32)) for p in (y0, cb0, cr0))
    m16 = intra_mode_decision(y, wmb=wmb, hmb=hmb, qp=QP)["mode16"]
    cmode = put(INTRA16_TO_CHROMA_MODE)[m16]
    wf = wavefront_i16_frame(y, cb, cr, m16, cmode, wmb=wmb, hmb=hmb,
                             qp=QP, qpc=qpc)
    src = put(y1.astype(np.int32))
    planes = interpolated_planes_jax(wf[0], ext)
    maps = pframe_maps(src, planes, put(np.zeros((wmb * hmb, 4, 2),
                                                 np.int32)),
                       wmb, hmb, window, QP)
    maxdiff = adaptive_maxdiff(src, wmb, hmb, -1)
    metric_id, lam = me_params(QP)
    dec = pframe_decide(src, planes, maps["int_map"], maps["c1mv"],
                        maps["q1map"], maps["c2mv"], maps["q2map"],
                        maps["q2ok"], maxdiff, wmb=wmb, hmb=hmb,
                        window=window, ext=ext, metric_id=metric_id,
                        lam=lam)
    ext_c = ext // 2 + 1
    g = jax.device_get
    return {
        "wmb": wmb, "hmb": hmb, "window": window, "ext": ext,
        "ext_c": ext_c, "qpc": qpc, "metric_id": metric_id, "lam": lam,
        "y": y0.astype(np.int32), "cb": cb0.astype(np.int32),
        "cr": cr0.astype(np.int32), "m16": g(m16), "cmode": g(cmode),
        "wf": g(wf), "src": y1.astype(np.int32), "planes": g(planes),
        "maps": {k_: g(v) for k_, v in maps.items()
                 if k_ not in ("metric_id", "lam", "ext")},
        "maxdiff": g(maxdiff),
        # integer-search centers in raster 8x8-block order
        "c1": g(_mbq_to_blocks(maps["c1mv"], wmb, hmb)),
        "mv": g(dec["mv"]),
        "cb_pad": g(pad_chroma_jax(wf[3], ext_c)),
    }


def _stages(inp):
    """(name, function, args) of every device stage that stands in for
    a removed hand-written kernel, plus the CAVLC slice packer."""
    from h264_fer.codec.device_entropy import i16_slice_entropy_impl
    from h264_fer.codec.device_pframe import (
        integer_score_map,
        mc_chroma_bulk,
        mc_luma_bulk,
        qpel_refine_map,
    )
    from h264_fer.kernels.wavefront import wavefront_i16_frame_impl
    from h264_fer.kernels.wavefront_p import pframe_decide_impl

    p = functools.partial
    wmb, hmb, ext = inp["wmb"], inp["hmb"], inp["ext"]
    mid = inp["metric_id"]
    m = inp["maps"]
    wf = inp["wf"]
    return [
        ("wavefront_i16_frame_impl",
         p(wavefront_i16_frame_impl, wmb=wmb, hmb=hmb, qp=QP,
           qpc=inp["qpc"]),
         (inp["y"], inp["cb"], inp["cr"], inp["m16"], inp["cmode"])),
        ("i16_slice_entropy_impl (CAVLC pack)",
         p(i16_slice_entropy_impl, wmb=wmb, hmb=hmb, nw=wmb * hmb * 24,
           cap=8),
         (inp["m16"], inp["cmode"], wf[1], wf[2], wf[5], wf[6])),
        ("integer_score_map",
         p(integer_score_map, ext=ext, window=inp["window"], metric_id=mid),
         (inp["src"], inp["planes"][0])),
        ("qpel_refine_map",
         p(qpel_refine_map, ext=ext, metric_id=mid),
         (inp["src"], inp["planes"], inp["c1"])),
        ("pframe_decide_impl",
         p(pframe_decide_impl, wmb=wmb, hmb=hmb, window=inp["window"],
           ext=ext, metric_id=mid, lam=inp["lam"]),
         (inp["src"], inp["planes"], m["int_map"], m["c1mv"], m["q1map"],
          m["c2mv"], m["q2map"], m["q2ok"], inp["maxdiff"])),
        ("mc_luma_bulk",
         p(mc_luma_bulk, ext=ext, wmb=wmb, hmb=hmb),
         (inp["planes"], inp["mv"])),
        ("mc_chroma_bulk",
         p(mc_chroma_bulk, ext_c=inp["ext_c"], wmb=wmb, hmb=hmb),
         (inp["cb_pad"], inp["mv"])),
    ]


def phase_e(dev, ref_dev, w: int = W, h: int = H, card: str = "",
            reps: int = 21):
    """Each device stage on dev vs ref_dev on identical inputs: outputs
    must be bit-equal. Prints each stage's compile seconds and memory
    analysis. Returns the warm timing of every stage on dev, which
    returns {stage: median seconds}."""
    import jax

    log(f"[e] per-stage {dev.platform} vs {ref_dev.platform} at {w}x{h}")
    inp = _stage_inputs(w, h, ref_dev)
    on_dev = []
    for name, fn, args in _stages(inp):
        jitted = jax.jit(fn)
        outs = {}
        for d in (dev, ref_dev):
            dargs = [jax.tree_util.tree_map(
                functools.partial(jax.device_put, device=d), a)
                for a in args]
            compiled = _compiled(f"[e] {name} on {d.platform}",
                                 lambda: jitted.lower(*dargs).compile())
            outs[d] = jax.device_get(compiled(*dargs))
            if d is dev:
                on_dev.append((name, compiled, dargs))
        a_leaves = jax.tree_util.tree_leaves(outs[dev])
        b_leaves = jax.tree_util.tree_leaves(outs[ref_dev])
        if len(a_leaves) != len(b_leaves) or not all(
                np.array_equal(a, b) for a, b in zip(a_leaves, b_leaves)):
            raise AssertionError(f"e: {name} differs between "
                                 f"{dev.platform} and {ref_dev.platform}")
        log(f"  [e] {name}: bit-equal")

    def warm() -> dict:
        times = {}
        for name, compiled, dargs in on_dev:
            runs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(compiled(*dargs))
                runs.append(time.perf_counter() - t0)
            runs.sort()
            times[name] = runs[reps // 2]
            log(f"  [e] {name}: warm {times[name] * 1e3:.3f} ms (min "
                f"{runs[0] * 1e3:.3f}, max {runs[-1] * 1e3:.3f}, median of "
                f"{reps}) on {dev.device_kind} ({card})")
        return times

    return warm


def one_card_phases(dev, ref_dev, card: str = "") -> dict:
    """Phases a-e at their full sizes, keyed by letter."""
    p = functools.partial
    return {"a": p(phase_a, dev), "b": p(phase_b, dev),
            "c": p(phase_c, dev), "d": p(phase_d, dev, ref_dev),
            "e": p(phase_e, dev, ref_dev, card=card)}


def run_phases(dev, phases: dict) -> None:
    """Run the phases' checks at once, so their compiles overlap; then
    their warm timings one after another, each with the card to itself.
    Any failure propagates."""
    def checked(key):
        warm, dt = _timed(phases[key])
        log(f"[{key}] checks passed in {dt:.1f} s")
        return warm

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(phases)) as pool:
        futs = {k: pool.submit(checked, k) for k in phases}
        warms = {k: f.result() for k, f in futs.items()}
    log(f"checks of all phases passed in {time.perf_counter() - t0:.1f} s")
    for warm in warms.values():
        if warm is not None:
            warm()
    log(f"  {_peak(dev)} (whole process)")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")


def phase_cards(devs, w: int = W, h: int = H, gop: int = 8) -> None:
    """The sharded sequence encoders on len(devs) cards vs the same
    encoder on one card: identical streams, and every card holds a
    shard. IPPP runs one GOP of `gop` frames per card."""
    from h264_fer.parallel.gop_device import (
        GopIntraEncoder,
        GopIpppEncoder,
    )
    from h264_fer.parallel.tile import TileIntraEncoder
    from h264_fer.parallel.tile_p import TileIpppEncoder

    n = len(devs)
    log(f"[cards] {n} cards vs 1 at {w}x{h}")

    def spread(label, arr):
        held = {s.device for s in arr.addressable_shards}
        if held != set(devs):
            raise AssertionError(f"{label}: shards on {sorted(map(str, held))}"
                                 f", expected all {n} cards")

    nmb = (w // 16) * (h // 16)
    intra = content(2 * n, w, h, seed=21)
    ippp = content(gop * n, w, h, seed=22)
    tile_gop = min(gop, 4)
    cases = [
        ("GopIntraEncoder", GopIntraEncoder, {}, intra),
        (f"GopIpppEncoder (GOP {gop})", GopIpppEncoder, {"gop_len": gop},
         ippp),
        ("TileIntraEncoder", TileIntraEncoder, {}, intra[:2]),
        (f"TileIpppEncoder (GOP {tile_gop})", TileIpppEncoder,
         {"gop_len": tile_gop}, ippp[:tile_gop]),
    ]
    encs = [(cls(w, h, QP, devices=devs, **kw),
             cls(w, h, QP, devices=devs[:1], **kw)) for _, cls, kw, _ in cases]
    # first calls of all eight encoders at once: their compiles overlap
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 * len(cases)) as pool:
        futs = [(pool.submit(m.encode_sequence, c[3]),
                 pool.submit(o.encode_sequence, c[3]))
                for (m, o), c in zip(encs, cases)]
        streams = [(fm.result(), fo.result()) for fm, fo in futs]
    log(f"  first calls (compiles overlapped): "
        f"{time.perf_counter() - t0:.1f} s")
    for (label, cls, _, frames), (multi, one), (got, want) in zip(
            cases, encs, streams):
        _same(f"cards: {label}", got, want)
        _, t_multi = _timed(multi.encode_sequence, frames)
        _, t_one = _timed(one.encode_sequence, frames)
        if cls is GopIntraEncoder:
            ys, cbs, crs = (np.stack([f[k] for f in frames])
                            for k in range(3))
            spread(label, multi._batched(nmb * 24, 8)(ys, cbs, crs)[0])
        elif cls is GopIpppEncoder:
            ys, cbs, crs = (np.stack([np.stack([f[k] for f in
                                                frames[g:g + gop]])
                                      for g in range(0, len(frames), gop)])
                            for k in range(3))
            spread(label, multi._batched(nmb * 24, 8)(
                ys, cbs, crs, multi._hdr_bits)[0])
        elif cls is TileIntraEncoder:
            band = (w // 16) * multi.hloc
            spread(label, multi._program(band * 24, 8)(*frames[0])[0])
        else:
            band = (w // 16) * multi.hloc
            spread(label, multi._i_program(band * 24, 8)(*frames[0])[0])
        log(f"  {label}: {len(got)} bytes identical to 1 card; "
            f"shards on all {n} cards; warm wall {t_multi:.3f} s on {n} "
            f"cards vs {t_one:.3f} s on 1 for {len(frames)} frames")
    for d in devs:
        log(f"  card {d.id}: {_peak(d)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    import jax

    # open only the cards this run drives (a JAX process reserves
    # memory on every card it opens)
    jax.config.update("jax_cuda_visible_devices",
                      ",".join(str(i) for i in range(args.cards)))
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    if len(devs) != args.cards:
        print(f"chip_smoke: needs {args.cards} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 1

    from h264_fer.native import get_lib
    from h264_fer.utils import enable_compilation_cache

    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log("card (nvidia-smi name, power.limit):")
    log(card)
    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} device(s); native C++ library "
        f"{'loaded' if get_lib() is not None else 'NOT loaded'}; "
        f"compile cache {cache}")

    if args.cards == 4:
        phase_cards(devs)
    else:
        run_phases(devs[0], one_card_phases(devs[0], jax.devices("cpu")[0],
                                            card))

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
