"""Generate h264_fer/ops/cavlc_tables.py from the oracle table dump.

The CAVLC code tables are constants from the H.264 norm (Tables 9-5,
9-7/9-8, 9-9, 9-10). We extract them via tools/oracle's dump_cavlc harness
(run on the reference's static data) and emit them in this package's uniform
layout. Run: python tools/gen_cavlc_tables.py /tmp/refbuild/cavlc_tables.json
"""

from __future__ import annotations

import json
import sys

import numpy as np


def fmt_array(name: str, arr: np.ndarray) -> str:
    inner = np.array2string(
        arr, separator=", ", threshold=10**9, max_line_width=78
    )
    return f"{name} = np.array(\n{inner},\n    dtype=np.int32)\n"


def main(json_path: str, out_path: str) -> None:
    d = json.load(open(json_path))

    def grab(key, shape):
        ln = np.array(d[f"{key}_len"], np.int32).reshape(shape)
        bits = np.array(d[f"{key}_bits"], np.int32).reshape(shape)
        return ln, bits

    ct_len = np.full((5, 17, 4), -1, np.int32)
    ct_bits = np.zeros((5, 17, 4), np.int32)
    for ctx, key in enumerate(["ct_nc0", "ct_nc2", "ct_nc4", "ct_nc8", "ct_cdc"]):
        ln, bits = grab(key, (17, 4))
        ct_len[ctx] = ln
        ct_bits[ctx] = bits
    tz_len, tz_bits = grab("total_zeros_4x4", (15, 16))
    tzc_len, tzc_bits = grab("total_zeros_cdc", (3, 4))
    rb_len, rb_bits = grab("run_before", (6, 7))

    header = '''"""CAVLC code tables (H.264 norm Tables 9-5, 9-7/9-8, 9-9, 9-10).

GENERATED by tools/gen_cavlc_tables.py from the norm-constant table data
(extracted via tools/oracle/dump_cavlc; semantically identical to the
reference's residual_tables.cpp:16-400, which transcribes the same norm
tables). Layout:

  COEFF_TOKEN_LEN/BITS[ctx, total_coeff, trailing_ones]
      ctx: 0: 0<=nC<2, 1: 2<=nC<4, 2: 4<=nC<8, 3: nC>=8, 4: nC==-1 (chroma
      DC). len == -1 marks invalid (T1s > TotalCoeff or > 3).
  TOTAL_ZEROS_LEN/BITS[total_coeff-1, total_zeros]        (4x4 blocks)
  TOTAL_ZEROS_CDC_LEN/BITS[total_coeff-1, total_zeros]    (2x2 chroma DC)
  RUN_BEFORE_LEN/BITS[min(zeros_left,7)-1, run_before]    (zeros_left 1..6;
      zeros_left > 6 uses the escape coding in cavlc.py)
"""

import numpy as np

'''
    with open(out_path, "w") as f:
        f.write(header)
        f.write(fmt_array("COEFF_TOKEN_LEN", ct_len))
        f.write("\n")
        f.write(fmt_array("COEFF_TOKEN_BITS", ct_bits))
        f.write("\n")
        f.write(fmt_array("TOTAL_ZEROS_LEN", tz_len))
        f.write("\n")
        f.write(fmt_array("TOTAL_ZEROS_BITS", tz_bits))
        f.write("\n")
        f.write(fmt_array("TOTAL_ZEROS_CDC_LEN", tzc_len))
        f.write("\n")
        f.write(fmt_array("TOTAL_ZEROS_CDC_BITS", tzc_bits))
        f.write("\n")
        f.write(fmt_array("RUN_BEFORE_LEN", rb_len))
        f.write("\n")
        f.write(fmt_array("RUN_BEFORE_BITS", rb_bits))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    json_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbuild/cavlc_tables.json"
    out = sys.argv[2] if len(sys.argv) > 2 else "h264_fer/ops/cavlc_tables.py"
    main(json_path, out)
