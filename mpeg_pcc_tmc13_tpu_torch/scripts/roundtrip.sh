#!/usr/bin/env bash
# Round-trip conformance step: encode -> md5 -> decode -> md5 -> compare.
# Mirrors the reference's scripts/Makefile.tmc13-step:20-35 contract
# (bitstream md5, encoder-side recon md5, decoder output md5).
#
# The PyTorch + CUDA port's copy of scripts/roundtrip.sh, driving the
# port's CLI (tmc3-cuda); run it from the repository root, or with the
# root on PYTHONPATH.  The decode runs with no options, so a stream of
# an on-device geometry engine (--geomEngine=rans) decodes on the
# current CUDA device.
#
# Usage: roundtrip.sh <input.ply> <workdir> [extra encoder options...]
set -euo pipefail

SRC=${1:?input ply}
DIR=${2:?workdir}
shift 2
CLI="python -m mpeg_pcc_tmc13_tpu_torch.runtime.cli"

mkdir -p "$DIR"
BIN="$DIR/stream.bin"
REC="$DIR/decoded.ply"

$CLI --mode=0 --uncompressedDataPath="$SRC" \
     --compressedStreamPath="$BIN" "$@" | tee "$DIR/encoder.log"
md5sum "$BIN" | tee "$DIR/stream.bin.md5"

$CLI --mode=1 --compressedStreamPath="$BIN" \
     --reconstructedDataPath="$REC" | tee "$DIR/decoder.log"
md5sum "$REC" | tee "$DIR/decoded.ply.md5"

echo "ok: $(wc -c < "$BIN") bytes"
