#!/bin/sh
# ControlNet-tile guided 4x upscale on the PyTorch port — the reference's
# flagship workflow (ref README.md:48-60; tile_methods/abstractdiffusion.py:
# 454-544), from a shell command (config-5-shaped: swap in an SDXL
# checkpoint + DemoFusion for the full BASELINE config 5).
#
#   MODEL       diffusers folder or single .safetensors (SD-1.5 class)
#   CONTROLNET  diffusers-layout ControlNet folder or .safetensors with
#               diffusers keys (e.g. control_v11f1e_sd15_tile); set it empty
#               to upscale without one
#   INIT, OUT   the input image and the output PNG
#   DEVICE      cuda (the default) or cpu
# Arguments after the script's name go on to the command line (for example
# --steps 30). PRINT_ARGS=1 prints the command's arguments, one a line, and
# runs nothing.
#
# The hint image defaults to the init image — exactly the ControlNet-tile
# recipe: the upscaled input conditions every tile so high-frequency
# detail is invented without drifting from the low-res content.
set -e
MODEL=${MODEL:-/ckpt/sd15}
CONTROLNET=${CONTROLNET-/ckpt/controlnet-tile}
INIT=${INIT:-input.png}
OUT=${OUT:-upscaled_4x.png}
DEVICE=${DEVICE:-cuda}

set -- img2img \
  --model-dir "$MODEL" \
  ${CONTROLNET:+--controlnet "$CONTROLNET" --control-weight 1.0} \
  --init "$INIT" \
  --upscaler Lanczos --scale-factor 4 \
  --denoising-strength 0.4 \
  --method "Mixture of Diffusers" --overlap 8 \
  --noise-inverse --noise-inverse-steps 10 \
  --steps 20 --cfg-scale 7 --bf16 \
  --device "$DEVICE" --out "$OUT" "$@"
if [ -n "$PRINT_ARGS" ]; then
  printf '%s\n' "$@"
  exit 0
fi
PYTHONPATH=$(dirname "$0")/../.. exec python -m mdu_tpu_torch.cli "$@"

# StableSR-style structure guidance instead of (or alongside) ControlNet:
#   ... --guidance-model guidance.safetensors --guidance-strength 1.0
