"""Command-line interface — the CLI counterpart of the reference's WinForms
GUI + Starter API (h264_Sucelje/H264.cs, fer_h264.cpp:166-216).

    python -m h264_fer encode in.y4m out.264 [options]
    python -m h264_fer decode in.264 out.y4m [--deblock]
    python -m h264_fer psnr ref.y4m test.y4m

Encode options mirror Starter::PostaviParametre (start/end frame, QP,
window size, tolerated error, intra period) plus the device pipeline and
deblocking superset knobs. Per-frame statistics (bytes, ms, MB-type
histogram — DohvatiStatistiku parity) print with --stats.
"""

from __future__ import annotations

import argparse
import sys
import time


def _read_frames(args, rd):
    for i, frame in enumerate(rd):
        if args.start_frame and i + 1 < args.start_frame:
            continue
        yield frame
        if args.end_frame and i + 1 >= args.end_frame:
            break


def _cmd_encode(args) -> int:
    from .codec.encoder import Encoder, EncoderConfig
    from .utils import enable_compilation_cache
    from .vio.y4m import Y4MReader

    if (args.device_modes or args.device_iframe or args.device_pframe or args.device_me
            or args.gop_devices or args.tile_devices):
        enable_compilation_cache()
    rd = Y4MReader(args.input)
    cfg = EncoderConfig(
        qp=args.qp,
        intra_every=args.intra_every,
        window_size=args.window_size,
        maxdiff=args.maxdiff,
        lossy_prefilter=not args.no_prefilter,
        scene_cut_idr=not args.no_scene_cut,
        deblock=args.deblock,
    )

    if args.gop_devices or args.tile_devices:
        # multi-device sequence encoders (parallel/): frames are read up
        # front; streams are byte-identical to the serial device paths
        import jax

        frames = list(_read_frames(args, rd))
        t0 = time.time()
        if args.tile_devices and args.intra_every > 1:
            from .parallel.tile_p import TileIpppEncoder

            enc = TileIpppEncoder(
                rd.width, rd.height, args.qp, gop_len=args.intra_every,
                window_size=args.window_size, maxdiff=args.maxdiff,
                lossy_prefilter=not args.no_prefilter,
                devices=jax.devices()[: args.tile_devices])
            stream = enc.encode_sequence(frames)
        elif args.tile_devices:
            from .parallel.tile import TileIntraEncoder

            enc = TileIntraEncoder(rd.width, rd.height, args.qp,
                                   devices=jax.devices()[: args.tile_devices])
            stream = enc.encode_sequence(frames)
        elif args.intra_every == 1:
            from .parallel.gop_device import GopIntraEncoder

            enc = GopIntraEncoder(
                rd.width, rd.height, args.qp,
                mode="mixed" if args.device_iframe == "mixed" else "i16",
                devices=jax.devices()[: args.gop_devices])
            stream = enc.encode_sequence(frames)
        else:
            from .parallel.gop_device import GopIpppEncoder

            enc = GopIpppEncoder(
                rd.width, rd.height, args.qp, gop_len=args.intra_every,
                window_size=args.window_size, maxdiff=args.maxdiff,
                lossy_prefilter=not args.no_prefilter,
                devices=jax.devices()[: args.gop_devices])
            stream = enc.encode_sequence(frames)
        dt = time.time() - t0
        with open(args.output, "wb") as f:
            f.write(stream)
        n, total = len(frames), len(stream)
        print(
            f"{n} frames {rd.width}x{rd.height} -> {total} bytes "
            f"in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps) "
            f"[{type(enc).__name__}]"
        )
        return 0

    device_pipeline = device_me = None
    if args.device_modes or args.device_iframe or args.device_pframe:
        from .codec.device_intra import DeviceIntraPipeline

        device_pipeline = DeviceIntraPipeline(rd.width, rd.height, args.qp)
    if args.device_me:
        from .ops.me import DeviceMePipeline

        device_me = DeviceMePipeline(window=args.window_size // 2)
    device_iframe = ({"off": False, "i16": True, "mixed": "mixed"}
                  [args.device_iframe or "off"])
    enc = Encoder(rd.width, rd.height, cfg, device_pipeline=device_pipeline,
                  device_me=device_me, device_iframe=device_iframe,
                  device_pframe=args.device_pframe)
    t0 = time.time()
    n = 0
    with open(args.output, "wb") as f:
        f.write(enc.headers())
        for frame in _read_frames(args, rd):
            f.write(enc.encode_frame(*frame))
            n += 1
    dt = time.time() - t0
    total = sum(s["bytes"] for s in enc.stats)
    print(
        f"{n} frames {rd.width}x{rd.height} -> {total} bytes "
        f"({total * 8 * rd.header.fps_num / max(1, n) / rd.header.fps_den / 1000:.1f} kbit/s) "
        f"in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps)"
    )
    if args.stats:
        print(f"{'frame':>5} {'type':>4} {'bytes':>7} {'ms':>8}  mb types "
              "[16x16 16x8 8x16 8x8 8x8r0 skip intra]")
        for i, s in enumerate(enc.stats):
            print(
                f"{i:>5} {'IDR' if s['idr'] else 'P':>4} {s['bytes']:>7} "
                f"{s['ms']:>8.1f}  {s['mb_types']}"
            )
    return 0


def _cmd_decode(args) -> int:
    from .codec.decoder import Decoder
    from .vio.y4m import Y4MWriter

    data = open(args.input, "rb").read()
    dec = Decoder(deblock=args.deblock)
    t0 = time.time()
    wtr = None
    n = 0
    for y, cb, cr in dec.decode_annexb(data):
        if wtr is None:
            wtr = Y4MWriter(args.output, y.shape[1], y.shape[0], args.fps, 1)
        wtr.write_frame(y, cb, cr)
        n += 1
    if wtr:
        wtr.close()
    dt = time.time() - t0
    print(f"{n} frames decoded in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps)")
    return 0


def _cmd_psnr(args) -> int:
    import numpy as np

    from .vio.y4m import Y4MReader, psnr

    a = list(Y4MReader(args.ref, crop_to_mb=False))
    b = list(Y4MReader(args.test, crop_to_mb=False))
    names = ("Y", "Cb", "Cr")
    for k in range(3):
        vals = [psnr(x[k], y[k]) for x, y in zip(a, b)]
        print(f"{names[k]}: mean {np.mean(vals):.2f} dB  min {np.min(vals):.2f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h264_fer", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="encode Y4M to Annex-B .264")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--qp", type=int, default=28)
    e.add_argument("--intra-every", type=int, default=100)
    e.add_argument("--window-size", type=int, default=16)
    e.add_argument("--maxdiff", type=int, default=-1)
    e.add_argument("--start-frame", type=int, default=0)
    e.add_argument("--end-frame", type=int, default=0)
    e.add_argument("--no-prefilter", action="store_true")
    e.add_argument("--no-scene-cut", action="store_true")
    e.add_argument("--deblock", action="store_true",
                   help="in-loop deblocking (superset; off = reference parity)")
    e.add_argument("--device-modes", action="store_true",
                   help="intra mode pre-decision on device")
    e.add_argument("--device-me", action="store_true",
                   help="motion search on device")
    e.add_argument("--device-iframe", nargs="?", const="i16",
                   choices=["off", "i16", "mixed"], default=None,
                   help="all-device I-frames: i16 (fast, Intra_16x16-only)"
                        " or mixed (exact I4x4-vs-I16 arbitration)")
    e.add_argument("--device-pframe", action="store_true",
                   help="all-device P-frames (ME maps + decision wavefront"
                        " + MC/recon + slice entropy in one program)")
    e.add_argument("--gop-devices", type=int, default=0, metavar="N",
                   help="shard the sequence over N devices on the gop mesh"
                        " axis (all-intra or fixed-GOP IPPP; implies the"
                        " device encode paths and scene-cut off)")
    e.add_argument("--tile-devices", type=int, default=0, metavar="N",
                   help="shard each frame's MB-row bands over N devices on"
                        " the tile mesh axis (all-intra)")
    e.add_argument("--stats", action="store_true")
    e.set_defaults(fn=_cmd_encode)

    d = sub.add_parser("decode", help="decode Annex-B .264 to Y4M")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--deblock", action="store_true",
                   help="apply the loop filter when the stream signals it")
    d.add_argument("--fps", type=int, default=24)
    d.set_defaults(fn=_cmd_decode)

    q = sub.add_parser("psnr", help="PSNR between two Y4M files")
    q.add_argument("ref")
    q.add_argument("test")
    q.set_defaults(fn=_cmd_psnr)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
