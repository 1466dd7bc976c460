#!/bin/bash
# Build the reference C decoder (h264bsd / SoftAVC) natively as the
# bit-exactness oracle for this decoder. Sources are read from the
# read-only reference mount; objects/binaries land in build/oracle
# (gitignored). The resulting `dectest` mirrors Decoder/src/DecTestBench.c
# golden-output behavior (writes out_wWhH.yuv per display-order frame).
set -euo pipefail
REF=${REF:-/root/reference/Decoder}
OUT=${OUT:-/root/repo/build/oracle}
mkdir -p "$OUT/obj"

CFLAGS="-O2 -DNDEBUG -I$REF/src -I$REF/inc -Wno-implicit-function-declaration -fno-strict-aliasing"

SRCS="h264bsd_transform h264bsd_util h264bsd_byte_stream h264bsd_seq_param_set \
h264bsd_pic_param_set h264bsd_slice_header h264bsd_slice_data \
h264bsd_macroblock_layer h264bsd_stream h264bsd_vlc h264bsd_cavlc \
h264bsd_nal_unit h264bsd_neighbour h264bsd_storage h264bsd_slice_group_map \
h264bsd_intra_prediction h264bsd_inter_prediction h264bsd_reconstruct \
h264bsd_dpb h264bsd_image h264bsd_deblocking h264bsd_conceal h264bsd_vui \
h264bsd_pic_order_cnt h264bsd_decoder H264SwDecApi extraFlags"

for s in $SRCS; do
  if [ "$REF/src/$s.c" -nt "$OUT/obj/$s.o" ] 2>/dev/null || [ ! -f "$OUT/obj/$s.o" ]; then
    gcc $CFLAGS -c "$REF/src/$s.c" -o "$OUT/obj/$s.o"
  fi
done

gcc $CFLAGS -c "$REF/src/DecTestBench.c" -o "$OUT/obj/DecTestBench.o"
# Both H264SwDecApi.c and DecTestBench.c define the default malloc/trace
# hooks (equivalent wrappers) — allow the duplicate at link time.
gcc "$OUT"/obj/*.o -o "$OUT/dectest" -Wl,--allow-multiple-definition

# Unit-level harness exposing internal reference functions (CAVLC residual
# block decode, Exp-Golomb) for table validation.
gcc $CFLAGS -c /root/repo/tools/oracle_harness.c -o "$OUT/obj/oracle_harness.o"
gcc "$OUT/obj/oracle_harness.o" \
    "$OUT/obj/h264bsd_cavlc.o" "$OUT/obj/h264bsd_stream.o" \
    "$OUT/obj/h264bsd_vlc.o" "$OUT/obj/h264bsd_util.o" \
    -o "$OUT/harness"
echo "harness built: $OUT/harness"
echo "oracle built: $OUT/dectest"
