#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``mdu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,reference,txt2img,samplers,deepcache,mesh,unclip,
                                    prompts,load,cli,layouts,img2img,adapters,stream,regional,
                                    upscale8k,stream8k,train,demofusion,reference_cli]

Phases, one JSON line each (all of them but ``stream8k`` and
``reference_cli``, which ``reference`` includes, unless ``--phases`` names
some; ``device`` and ``build`` always run):

1. ``device``    the card's name and count; the ``nvidia-smi`` name and power
                 limit line is printed as it is.
2. ``build``     builds every CUDA kernel from ``mdu_tpu_torch/csrc`` (one
                 nvcc per source, in parallel), with the ptxas register and
                 shared-memory lines.
3. ``kernels``   each bf16 kernel at its config-2 shapes and one ragged shape,
                 held against its plain PyTorch version run in fp32 on the
                 same inputs: the kernel's max abs error must stay within 2x
                 the bf16 plain version's error + 1e-3. The fp32 kernels of
                 #1 and #2 (and #1 with ``bf16_exp``) at config 2's shapes,
                 the VAE's, a ragged one and an odd D, each within 1e-4 of
                 its plain version; each fp32 line names its form (sm90, wide
                 or simt, which must be the one its shape calls for), and at
                 the config-2-sized shapes the CUDA-core simt form runs on
                 the same inputs, held to the same bar and timed. Its bound
                 is three TF32 passes at 495 TFLOP/s (``fma_bound_ms``: fp32
                 on the CUDA cores); for attention SDPA is timed also under
                 the efficient-attention backend, with the default call's
                 backend named. The fp32 #1 and #2 also at the main path's
                 three shapes with q x 3 (``_f32_sharp``: scores of std 3,
                 a sharp softmax), each launch counted under its form, within
                 1e-4. #4 at six shapes config 2 runs under MDU_FUSED_GN=1
                 and a ragged one in bf16, and in fp32 at level 0 and at a
                 group past what a cluster holds: each line names the form
                 ``gn_plan`` picks (cluster or two_read) and its counter must
                 move; at config 2's shapes the other form runs on the same
                 inputs too, held to the same bar and timed; a constant
                 group must give the bias. #5's first line also times an
                 empty kernel on its grid through the same launch path
                 (``floor_ms``, ``floor_device_ms``). #6 in fp32 at config
                 2's four shapes with
                 ``fuse_act``, the first without, a ragged shape off its
                 tile (sm90) and C = 12 (simt), in the same way. #1 and #3
                 also at D = 13 (their mma.sync forms), #1 and its
                 ``bf16_exp`` at the VAE's [2, 1, 9600, 512] (the wide form),
                 #1 with ``clamp`` there too, ``bf16_exp`` also at D = 13
                 (every ``bf16_exp`` line on small-integer q and k and a
                 power-of-two scale: each score exact, none ambiguous, and
                 the plain version the same to the bit with q.k summed in
                 reverse); #1 and #2 at D = 200 (wide) and 300 (D % 8 != 0:
                 the split-D mma.sync kernel); each line names the form the
                 wrapper took, which must be the one its shape calls for. At
                 config 2's shapes #1 and #3 take their warpgroup (sm90)
                 form, #2 and #1 at D = 512 their warpgroup (wide) form, and the
                 earlier mma.sync form runs on the same inputs too, held to
                 the same bar and timed (``earlier_ms``); the line adds the
                 MUFU exp floor
                 (``mufu_floor_ms``: one ex2 per score at 16 a clock per SM
                 on 132 SMs, at the ``clocks.max.sm`` nvidia-smi reads).
                 #6 at config 2's four shapes takes its warpgroup (sm90)
                 form, and its mma.sync form runs beside it in the same way;
                 its tiny and unaligned shapes take the mma.sync form.
                 Times from CUDA events around a loop of calls (``ms``, which
                 includes the wrapper's host time where that is longer than
                 the kernel's): kernel, plain version, and one
                 PyTorch call that computes the same function as a yardstick
                 only (the port never calls it): ``F.scaled_dot_product_attention``
                 for attention, ``F.group_norm`` for GroupNorm, cuDNN's
                 ``F.conv2d`` on the pre-activated input for the fused conv
                 ("conv alone": no one call computes the fused function),
                 ``index_add_`` into the flat canvas for the tile blend (its
                 fp32 raw sums). The img2img path's shapes: #1 and #3 at
                 config 3's UNet levels 0-2 ([10, 8, 576, 160]: the sm90
                 form's widest head), #2 at config 3's and the 8K's VAE
                 mid-blocks ([4, 1, 17424, 512]: a ragged last block), #4 at
                 config 3's level 0 in both forms, #5 on config 3's Mixture
                 of Diffusers canvas with gaussian-weighted tiles, #6 at
                 [10, 96, 96, 320] -> 320. The regional path's shapes
                 (config 4): #1 and #3 at its region calls' levels 0-2 ([2, 8,
                 9216, 40], [2, 8, 2304, 80], [2, 8, 576, 160]), #2 at its
                 decoder mid-block [4, 1, 13924, 512] (4 tiles of 118
                 latent), #4 at [2, 320, 96, 96] and [2, 640, 48, 48], #5 on
                 its 9 tiles of 96 over the 192 x 192 canvas, #6 at [2, 96,
                 96, 320] -> 320 and [2, 48, 48, 640] -> 640. Config 5's (SDXL,
                 D = 64): #1 and #3 at [4, 10, 4096, 64], [4, 20, 1024, 64]
                 and their batch-2 forms, #4 at [4, 320, 128, 128] (cluster),
                 [4, 640, 64, 64], [4, 1280, 32, 32] and [4, 2560, 32, 32],
                 #6 at [4, 128, 128, 320] -> 320, [4, 64, 64, 640] -> 640,
                 the [4, 64, 64, 320] -> 640 transition and levels 0 and 1 at
                 batch 2. Config 2 under NHWC (``NHWC_CONV_SHAPES``): #6
                 at 1280 -> 1280 on [10, 8, 12] and [10, 16, 24], 640 -> 1280
                 on [10, 16, 24], 960 -> 640 and 1280 -> 640 on [10, 32, 48].
                 The backward in fp32 and bf16 in its tensor-core forms
                 (``csrc/flash_attention_bwd_sm90.cuh``: f32_sm90,
                 bf16_sm90) at the train step's levels [2, 8, 4096, 40]
                 and [2, 8, 1024, 80], at [2, 10, 4096, 64], [2, 8, 576, 160]
                 and ragged 1000 x 777, and at the two train levels also in
                 its CUDA-core form (``csrc/flash_attention_bwd.cu``:
                 f32_simt, bf16_simt, the earlier time), against autograd
                 through #1's fp32 plain version (fp32 within 1e-4 x max,
                 bf16 within 2x the bf16 plain version's error + 1e-3 x
                 max), the backward of
                 ``F.scaled_dot_product_attention`` its yardstick
                 (``check_attention_bwd``). ``device_ms`` and
                 ``library_device_ms``: the device time alone of the kernel's
                 and the yardstick's launches (torch.profiler's kernel
                 durations, summed, per call). Bounds: max(flops / peak, bytes /
                 3.35 TB/s), peak 989 TF/s in bf16 and 67 TF/s in fp32, bytes
                 = each input read once and each output written once.
4. ``reference`` a tiny txt2img and a tiny img2img (Mixture of Diffusers,
                 noise inversion, the exact tiled encode and decode, the fast
                 encode with color_fix and the fast decode), sized so that
                 their attention reaches the flash kernels, on the card
                 against the same pipelines on the CPU: fp32 within 1e-4 of
                 the largest value; bf16 within 2x the CPU bf16 run's error
                 against CPU fp32, + 1e-3 of it.
                 Once with no flag (the fm kernel must launch; in fp32 its
                 sm90 form) and once with MDU_FLASH=trans MDU_FUSED_GN=1
                 MDU_FUSED_CONV=1 MDU_FUSED_BLEND=1 (each flagged kernel must
                 launch; in fp32 the trans attention is flash_attention_f32's
                 sm90 form). With each, a tiny regional txt2img (one
                 BACKGROUND and one FOREGROUND region) under MultiDiffusion
                 and under Mixture of Diffusers, its noise composed on the
                 CPU. With each, a tiny SDXL UNet + ControlNet (random zero
                 gates, a nonzero hint) DemoFusion x2 from a 48 x 48 latent,
                 its base and phase noise drawn on the CPU, both phases'
                 latents held. Then, with no flag, the tiny pipeline
                 (untiled, 1024 tokens at level 0) under each of the 15
                 samplers, "DPM++ 2M Karras" and Euler with churn, the
                 samplers' noise drawn on the CPU and copied to the card; DPM
                 adaptive must take the same accept / reject decisions on the
                 card as on the CPU in fp32; in bf16 both devices' decisions
                 are printed, with the first that differs, both factors
                 there, the 0.81 they are held against and bf16's rounding
                 of the factor (``_first_difference``). Last, this slice's
                 tiny paths, the same way (``phase_reference_slice``): the
                 streaming VAE's decode and encode in stream-device,
                 stream-host and stream-host with fp8 spills (the fp8 runs
                 against the CPU's fp32 run without spills, within 2x the
                 CPU fp8 run's own error + 1e-3 of the largest value), the
                 tiny conditioner on a prompt with emphasis, BREAK, a
                 schedule and AND and a txt2img from it, and a tiny
                 single-file round trip with a LoRA merge. Then PR 13's tiny
                 paths (``phase_reference_adapters``): DeepCache N = 2 on a
                 tiled txt2img with a BACKGROUND region under Euler, Heun and
                 Euler a; a DemoFusion x2 with DeepCache and an AND cond;
                 StableSR + ControlNet on a tiled img2img; image CFG 1.5;
                 unCLIP; a tiny ESRGAN x4. #1 at SD2.1-unCLIP's D = 64 on
                 config 2's canvas ([10, 5, 6144, 64], [10, 10, 1536, 64])
                 and at config 3's 3-way image-CFG batches (15 and 12 at
                 levels 0-2) are in ``kernels``.
                 Last, PR 14's (``phase_reference_cli``, also named alone as
                 ``reference_cli``): the CLI's tiny txt2img (a tiny single
                 file, ``--device cuda`` and ``--device cpu``: PNGs within 1
                 uint8 level, the infotexts equal); a narrow UNet whose level
                 1 is 768 wide, built under ``MDU_UNET_LAYOUT=NHWC`` and run
                 under ``MDU_FUSED_CONV=1`` in fp32 and bf16 (#6 takes every
                 conv the fused path takes, some above 640 channels);
                 ``conv3x3_mm`` in both modes and layouts, fp32 and bf16,
                 with the route of its bf16 products.
5. ``txt2img``   config 2 through ``DiffusionPipeline.txt2img``: SD1.5 UNet and
                 VAE with random bf16 weights, MultiDiffusion at 2048 x 512
                 (tile 96, overlap 48, tile_bs 8), Euler 20 steps at CFG 7,
                 exact tiled decode (tile 128); 1 warm image (and 1 timed
                 outside ``WARM_ONLY``), with no flag, with the four flags
                 and with MDU_FLASH=fm
                 (the VAE's D = 512 through #1's wide form). Then one image
                 of config 2 built in fp32 (the JAX CLI's default dtype)
                 under MDU_FUSED_CONV=1: #6 in fp32, #1 and #2 in fp32.
                 Launch counts are set to 0 just before each image and read
                 just after; each kernel's launches per image must equal the
                 pinned count (and a kernel of the path launched 0 times
                 fails the run).
6. ``samplers``  config 2 under "DPM++ 2M Karras" (a warm image) and "DPM++
                 SDE" (1 warm and 1 timed), launches pinned: #1 200 and 390, the
                 latter 39 UNet calls: two on each of 19 steps, one on the
                 last).
6b. ``deepcache`` config 2 exactly as ``txt2img`` builds it under DeepCache N
                 = 2, branch 1 (``bench.py``'s config2_deepcache_img_per_min),
                 with no flag and the four flags: 1 warm and 2 timed images,
                 launches pinned (#1 / #3 150, #5 0: the DeepCache grid
                 sums with the scatter-add), and the mean absolute pixel
                 difference of the seed-0 image from the exact one.
6e. ``mesh``     config 2 as ``txt2img`` builds it under ``deterministic`` on a
                 tile mesh (``phase_mesh``): one device without a mesh, a
                 1-shard mesh, a 2-shard mesh on cuda:0 (also under
                 MDU_FUSED_BLEND=1: #5 0) and the 2-shard mesh under
                 DeepCache N = 2; launches pinned (#1 400 and #2 2 an image
                 on two shards: two UNet calls a step, the decode's 2 tiles
                 one a shard), img/min and peak memory, each mesh image's
                 latents to the bit or within 1e-3 x max of one device's;
                 then the sharded exact decode of the same latents against
                 the lockstep decode: in fp32 within 1 uint8 level, in bf16
                 within 2 e + 1e-3 x max (e: bf16's error against fp32).
                 Last, DemoFusion x2 of the same SD1.5 from 512^2 on one
                 device and on two shards of cuda:0 (``run_mesh_demofusion``:
                 windows and views sharded, launches pinned, the latents to
                 the bit or within 1e-3 x max of one device's).
6c. ``unclip``   SD2.1-unCLIP (ViT-H, adm 2048) on config 2's canvas and
                 sampler, random bf16 weights; 1 warm and 1 timed image,
                 #1's launches at D = 64 pinned.
6a. ``prompts``  config 2 from prompt strings (``phase_prompts``): a plain
                 prompt and a schedule with an AND of two weighted branches
                 through a full-width CLIP-L with random bf16 weights and a
                 char-level vocab; each encode's ms, the conds held to the
                 CPU conditioner on the same weights (bf16 bar), 1 warm and
                 1 timed image each with launches pinned; the SDXL
                 conditioner (CLIP-L + OpenCLIP-bigG) on one pair.
6b. ``load``     config 2's weights and a random CLIP-L written as one LDM
                 single file (bf16) with a tokenizer folder and a rank-8
                 kohya LoRA, in a temporary directory of the checkout,
                 loaded with ``load_single_file``: every tensor bit-equal,
                 the config-2 image equal to the in-memory pipeline's, the
                 merged LoRA within one bf16 rounding of the fp32 reference
                 (``phase_load``).
6c. ``cli``      config 2 through the command line (``phase_cli``): its
                 weights and a random CLIP-L as one single file with a
                 char-level tokenizer in ``_cli_smoke_*/`` of the checkout
                 (deleted afterwards); ``python -m mdu_tpu_torch.cli
                 txt2img`` at config 2's settings in a subprocess (seconds
                 to start, to load and for the image; its ``perfcount``
                 line with the peak device memory); its PNG read back
                 (2048 x 512, the infotext, ``info`` printing it); the same
                 image in this process twice (the CLI's pixels within the
                 two images' spread; #1 200, #2 1); an image interrupted by
                 its step callback after step 10 (#1 100, "Interrupted" in
                 its infotext); ``cli.main(["img2img", ...])`` at config 3's
                 settings (#1 570, #2 2).
6d. ``layouts``  config 2 under ``MDU_UNET_LAYOUT=NHWC`` with no flag and
                 with the four flags (#6 720 an image: 36 convs a UNet call,
                 20 of them above 640 channels; #4 0), ``MDU_GN=fold``,
                 ``chanreduce``, ``MDU_CONV_MM=9mm``, ``im2col``: 1 warm and 1
                 timed image each against the default's, launches pinned,
                 img/min and peak memory, each warm image's latents within 3
                 e + 1e-3 x max of the default's (e: the default's max
                 difference from the fp32 latents of the same weights).
7. ``img2img``   config 3 through ``DiffusionPipeline.img2img`` as
                 ``bench.py:345-377`` runs it: a 512 x 512 image, Lanczos x4
                 to 2048 x 2048, Mixture of Diffusers (tile 96, overlap 8,
                 ``tile_bs`` 8: 9 tiles in batches of 5 and 4), noise
                 inversion (10 steps, renoise 1), Euler 20 steps at denoise
                 0.4 (9 steps) and CFG 7, exact tiled encode (tile 1024) and
                 decode (tile 64); SD1.5 in bf16, with no flag and with the
                 four flags; ``free_cache()`` before each of 1 warm and 1
                 timed image. Launches per image pinned; the output (1,
                 2048, 2048, 3), finite, and the decode's NaN chain not taken.
7b. ``adapters`` config 3 (no flag) three ways, 1 warm and 1 timed image
                 each, seconds per stage, peak memory, launches pinned: with
                 a full-width StableSR guidance encoder (the init image's
                 latent as the guidance leaf); with a full-width ESRGAN x4
                 (64 features, 23 blocks) written with the port's writer,
                 loaded by ``load_esrgan`` and registered as the
                 pre-upscaler, held card against CPU on a 64 x 64 crop in
                 fp32 and its x4 of 512 x 512 timed; under image CFG 1.5 on
                 an SD1.5 UNet with 8 input channels.
7a. ``stream``   config 3's exact decode and encode in lockstep,
                 stream-device, stream-host and stream-host with fp8 spills,
                 each forced by an ``MDU_HBM_BYTES`` budget and the mode
                 checked, against a stream-host run of the fp32 VAE;
                 seconds, peak memory and #2's launches (one a group) of
                 each (``phase_stream``).
8. ``regional``  config 4 through ``DiffusionPipeline.txt2img`` as
                 ``bench.py:545-577`` runs it: 1536 x 1536 (a 192 x 192
                 latent), four BACKGROUND regions of 0.5 x 0.5 at the
                 quadrants, each with its own (cond, uncond), MultiDiffusion
                 (tile 96, overlap 48, ``tile_bs`` 8: 9 tiles in batches of 5
                 and 4) with the background drawn, Euler 20 steps at CFG 7,
                 exact tiled decode (tile 96: 4 tiles); SD1.5 in bf16, with no
                 flag and with the four flags; ``free_cache()`` before each of
                 1 warm and 1 timed image. 120 UNet calls an image (20 steps
                 x (2 grid calls + 4 region calls)); launches per image
                 pinned; seconds per stage (sampling, decode) and the peak
                 memory.
9. ``upscale8k`` one 2048 x 2048 -> 8192 x 8192 upscale with no flag
                 (``bench.py:479-533``: config 3's settings with the fast
                 tiled VAE, encoder tile 512, decoder tile 64, ``tile_batch``
                 8), ``decode=False`` and then ``_decode_tensor``; launches
                 pinned, the output finite; its 18 tile batches make the
                 plan decide the JAX package's scan grid (``scan_tiles``),
                 which the port runs unrolled.
9a. ``stream8k`` (named only) the 8K's exact decode in the mode the
                 pipeline picks: mode, footprints against free memory,
                 seconds, peak device memory, host peak RSS.
9b. ``train``    the dp x tp train step (``parallel/training.py``) at SD1.5's
                 full width in fp32, TF32 off (``phase_train``): batch 2 of
                 [4, 64, 64] latents and [2, 77, 768] context, 3 steps at dp =
                 tp = 1 (seconds a step, samples/s, peak memory; #1 10 and
                 the backward kernel 10 a step), step 1 under remat (#1 20),
                 step 1 with the long attentions patched here onto #1's
                 plain version (no kernel launched), step 1 at dp = 2 x tp
                 = 2 on cuda:0 x 4 (#1 and the backward 20); each against
                 the kernel step: loss, gradient and parameters.
10. ``demofusion`` config 5 through ``DiffusionPipeline.demofusion`` as
                 ``bench.py:579-640`` builds it: the SDXL UNet and a ControlNet
                 of its config (and the SD VAE, built and not run), random
                 bf16 weights drawn on the card, the ControlNet's gates zero;
                 crossattn [1, 77, 2048], vector zeros, a zero 1024 x 1024
                 hint; DemoFusion x3 from 1024 x 1024 (windows 128 at overlap
                 64, window and view batches of 2), Euler 20 steps, CFG 7,
                 denoise 0.45, no decode. Last, after the other phases'
                 pipelines are released. A warm x2 image, one timed x3 image
                 with no flag (seconds per phase, img/min, peak memory; a
                 finite [1, 4, 384, 384] final latent and three phase
                 latents) and one x2 image under the four flags; launches
                 pinned in each (270 guided calls a x3 image, 45 a x2 one:
                 the x2 images run 10 steps).
                 Last, a x2 image under DeepCache N = 2 (the base phase and
                 the global views cached), launches pinned, with its mean
                 absolute latent difference from the exact x2.

The reference phases' CPU runs go to ``CPU_REF_WORKERS`` worker processes,
submitted before the kernel checks so that they run beside them and while
the card runs its own, and the settings in ``WARM_ONLY`` (config 2
under ``MDU_FLASH=fm``, the samplers' "DPM++ 2M Karras", and the
``layouts`` phase's ``MDU_GN`` and ``MDU_CONV_MM`` settings) keep their
warm image, its checks and its pinned launches but time no second image:
this pays for the ``cli``, ``layouts`` and ``mesh`` phases within the run's
time.

Then a ``done`` line with the script's seconds and each phase's, a
``{"kernels": [...]}`` line
(every kernel of the port), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
TF32 is off for matmuls and convolutions.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 on the CUDA cores
PEAK_TF32_FLOPS = 495e12      # H100 SXM dense TF32 (the fp32 attention's three passes)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
F32_TOL = 1e-4                # fp32 kernels against their plain versions
CFG2 = dict(width=2048, height=512, steps=20, cfg=7.0, tile=96, overlap=48,
            tile_bs=8, decoder_tile=128)
FLAGS = {"MDU_FLASH": "trans", "MDU_FUSED_GN": "1", "MDU_FUSED_CONV": "1",
         "MDU_FUSED_BLEND": "1"}
# launches per config-2 image; every other kernel must launch 0 times
# ("name.form" counts the launches of one form of a kernel)
EXPECTED_LAUNCHES = {"flash_attention_fm": 200, "flash_attention_fm.sm90": 200,
                     "flash_attention": 1, "flash_attention.wide": 1}
EXPECTED_FLAGGED = {"flash_attention_t": 200, "flash_attention_t.sm90": 200,
                    "flash_attention": 1, "flash_attention.wide": 1, "fused_group_norm": 340,
                    "fused_group_norm.cluster": 120, "fused_group_norm.two_read": 220,
                    "fused_conv3x3": 320, "fused_conv3x3.sm90": 320, "fused_tile_blend": 20}
EXPECTED_FM = {"flash_attention_fm": 201, "flash_attention_fm.sm90": 200,
               "flash_attention_fm.wide": 1}
CONFIG2_RUNS = (("default", {}, EXPECTED_LAUNCHES), ("flagged", FLAGS, EXPECTED_FLAGGED),
                ("fm", {"MDU_FLASH": "fm"}, EXPECTED_FM))
# one image of config 2 built in fp32, under MDU_FUSED_CONV=1
F32_RUN = ("fp32 conv", {"MDU_FUSED_CONV": "1"},
           {"fused_conv3x3_f32": 320, "fused_conv3x3_f32.sm90": 320,
            "flash_attention_fm_f32": 200, "flash_attention_fm_f32.sm90": 200,
            "flash_attention_f32": 1, "flash_attention_f32.wide": 1})
# timed images of the earlier paths (config 2's three settings, configs 3 and 4):
# 1 after 1 warm, cut from 2 to keep the whole run near half its time limit
EARLIER_TIMED = 1
# (phase, setting) pairs that keep their warm image, its checks and pinned
# launches but time no second image (cut with the reference phases' CPU
# workers to pay for the cli and layouts phases; such a line reports its warm
# image's seconds)
WARM_ONLY = {("txt2img", "fm"), ("samplers", "DPM++ 2M Karras"),
             ("layouts", "MDU_GN=fold"), ("layouts", "MDU_GN=chanreduce"),
             ("layouts", "MDU_CONV_MM=9mm"), ("layouts", "MDU_CONV_MM=im2col")}
# config 3 (bench.py:345-377): MoD img2img x4, 512 -> 2048, with noise inversion
CFG3 = dict(image=512, scale=4.0, steps=20, cfg=7.0, denoise=0.4, tile=96, overlap=8,
            tile_bs=8, inverse_steps=10, renoise=1.0, encoder_tile=1024, decoder_tile=64)
# launches per config-3 image: 38 UNet calls (inversion 10 x 2 tile batches,
# sampling 9 x 2), 15 attentions at L >= 512 a call (levels 0-2), and the
# encoder's and the decoder's mid-blocks in one lockstep call each
EXPECTED_CONFIG3 = {"flash_attention_fm": 570, "flash_attention_fm.sm90": 570,
                    "flash_attention": 2, "flash_attention.wide": 2}
# under the four flags: 17 #4 a UNet call (the cluster form at level 0 in
# the sampling calls' batches of 10 and 8: 6 a call), 16 #6, 1 #5 a denoiser call
EXPECTED_CONFIG3_FLAGGED = {"flash_attention_t": 570, "flash_attention_t.sm90": 570,
                            "flash_attention": 2, "flash_attention.wide": 2,
                            "fused_group_norm": 646, "fused_group_norm.cluster": 108,
                            "fused_group_norm.two_read": 538, "fused_conv3x3": 608,
                            "fused_conv3x3.sm90": 608, "fused_tile_blend": 19}
CONFIG3_RUNS = (("default", {}, EXPECTED_CONFIG3), ("flagged", FLAGS, EXPECTED_CONFIG3_FLAGGED))
# the 2K -> 8K upscale (bench.py:479-533, _vae_8k_config at :397-404): 342 UNet
# calls (18 tile batches x (10 + 9)); #2 in 32 encoder and 32 decoder chunks
# and the two statistics passes
CFG8K = dict(image=2048, encoder_tile=512, decoder_tile=64, tile_batch=8)
EXPECTED_8K = {"flash_attention_fm": 5130, "flash_attention_fm.sm90": 5130,
               "flash_attention": 66, "flash_attention.wide": 66}
# config 4 (bench.py:545-577): 4 BACKGROUND regions at the quadrants of a
# 1536 x 1536 MultiDiffusion txt2img
CFG4 = dict(width=1536, height=1536, steps=20, cfg=7.0, tile=96, overlap=48, tile_bs=8,
            decoder_tile=96, quadrants=((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)))
# launches per config-4 image: 120 UNet calls (20 steps x (grid batches of 5
# and 4 tiles + 4 regions)), 15 attentions at L >= 512 a call, and the
# decoder's mid-block in one lockstep call (4 tiles of 118 latent)
EXPECTED_CONFIG4 = {"flash_attention_fm": 1800, "flash_attention_fm.sm90": 1800,
                    "flash_attention": 1, "flash_attention.wide": 1}
# under the four flags: 17 #4 a UNet call (the cluster form at level 0 in the
# grid calls' batches of 10 and 8: 6 a call), 16 #6 a call, 1 #5 a step (the
# grid; the region adds follow it)
EXPECTED_CONFIG4_FLAGGED = {"flash_attention_t": 1800, "flash_attention_t.sm90": 1800,
                            "flash_attention": 1, "flash_attention.wide": 1,
                            "fused_group_norm": 2040, "fused_group_norm.cluster": 240,
                            "fused_group_norm.two_read": 1800, "fused_conv3x3": 1920,
                            "fused_conv3x3.sm90": 1920, "fused_tile_blend": 20}
CONFIG4_RUNS = (("default", {}, EXPECTED_CONFIG4), ("flagged", FLAGS, EXPECTED_CONFIG4_FLAGGED))
# config 5 (bench.py:579-640): SDXL DemoFusion x3 with ControlNet from a 1024 x
# 1024 base; windows 128 at overlap 64, window and view batches of 2
# (MDU_BENCH_C5_TILE_BS's default), Euler 20 steps at CFG 7, denoise 0.45
# (t_enc 9: 10 steps a phase), seed 0, no decode; the x2 images (warm, four
# flags, DeepCache) at 10 steps (t_enc 4: 5 steps a later phase), cut to keep
# the whole run near its time
CFG5 = dict(size=1024, window=128, overlap=64, scale=3, tile_bs=2, steps=20, cfg=7.0,
            denoise=0.45, steps_x2=10)
# guided calls (UNet + ControlNet at batch 2 x CFG) an image: phase 1 20
# (untiled 128^2); phase 2 (256^2) 10 steps x (5 window + 2 view batches);
# phase 3 (384^2) 10 x (13 + 5); a x2 image at 10 steps 10 + 5 x 7. 104
# self-attentions at L >= 512 a call: the UNet's 70 (down 4 + 20, mid 10, up
# 30 + 6), the ControlNet's 34
C5_CALLS = {2: 10 + 35, 3: 20 + 70 + 180}
EXPECTED_CONFIG5 = {"flash_attention_fm": 104 * C5_CALLS[3],
                    "flash_attention_fm.sm90": 104 * C5_CALLS[3]}
EXPECTED_CONFIG5_X2 = {"flash_attention_fm": 104 * C5_CALLS[2],
                       "flash_attention_fm.sm90": 104 * C5_CALLS[2]}
# x2 under the four flags: #3 as #1; #4 17 a call (the transformer norms, 11 +
# 5, and the UNet's norm_out; the ResBlock norms fold into #6), the cluster
# form for norm_out at batch 4 (42 MB: 30 calls of phase 2, its 4 full window
# batches and 2 view batches in each of 5 steps); #6 22 a call
# (levels 0 and 1 where C, Co <= 640 and the JAX planner fits the conv: the
# UNet's 14, the ControlNet's 8); no #5 (DemoFusion fuses its windows itself)
EXPECTED_CONFIG5_FLAGGED = {"flash_attention_t": 104 * C5_CALLS[2],
                            "flash_attention_t.sm90": 104 * C5_CALLS[2],
                            "fused_group_norm": 17 * C5_CALLS[2], "fused_group_norm.cluster": 30,
                            "fused_group_norm.two_read": 17 * C5_CALLS[2] - 30,
                            "fused_conv3x3": 22 * C5_CALLS[2],
                            "fused_conv3x3.sm90": 22 * C5_CALLS[2]}
# config 2 under two more samplers: (name, #1 launches per image = 10 a UNet call)
SAMPLER_RUNS = (("DPM++ 2M Karras", 200), ("DPM++ SDE", 390))
# config 2 under DeepCache as bench.py:294-342 runs it (config2_deepcache_img_per_min):
# N = 2, branch 1. 10 full UNet calls (10 flash calls each: levels 0 and 1) and
# 10 cached ones (level 0's 2 down and 3 up transformers: 5 each)
DEEPCACHE = dict(interval=2, branch=1)
EXPECTED_DEEPCACHE = {"flash_attention_fm": 150, "flash_attention_fm.sm90": 150,
                      "flash_attention": 1, "flash_attention.wide": 1}
# under the four flags: #4 17 a full call and 6 a cached one (level 0's five
# transformer norms and norm_out, all in the cluster form at batch 10); #6 16
# a full call and 9 a cached one (down 0's four convs, up 3's three conv2 and
# the conv1 of its last two ResBlocks, whose input is 640 wide); #5 never: the
# DeepCache grid sums with the scatter-add, as the JAX package's stateful grid
EXPECTED_DEEPCACHE_FLAGGED = {"flash_attention_t": 150, "flash_attention_t.sm90": 150,
                              "flash_attention": 1, "flash_attention.wide": 1,
                              "fused_group_norm": 230, "fused_group_norm.cluster": 120,
                              "fused_group_norm.two_read": 110, "fused_conv3x3": 250,
                              "fused_conv3x3.sm90": 250}
DEEPCACHE_RUNS = (("default", {}, EXPECTED_DEEPCACHE),
                  ("flagged", FLAGS, EXPECTED_DEEPCACHE_FLAGGED))
# config 2 on a tile mesh under ``deterministic`` (every UNet call padded to
# tile_bs 8: 16 samples with CFG). One shard: the 5 tiles in one call a step,
# as on one device; two shards on the one card: 3 tiles each (the last tile
# repeated to pad 5 to 6), one call a shard, so two a step and #1 twice
# one device's; the sharded exact decode's 2 tiles one a shard, so #2 once a
# shard; #5 never on the mesh, under MDU_FUSED_BLEND too
MESH_SHARDS = (1, 2)
EXPECTED_MESH = {1: EXPECTED_LAUNCHES,
                 2: {"flash_attention_fm": 400, "flash_attention_fm.sm90": 400,
                     "flash_attention": 2, "flash_attention.wide": 2}}
# DemoFusion x2 on the mesh (SD1.5, config 2's pipeline): 512^2 -> 1024^2,
# windows of 96 latent at overlap 64 (4 of them) and 4 dilated views, both in
# calls of 2; Euler 10 steps, denoise 0.45
DF_MESH = dict(size=512, window=96, overlap=64, steps=10, denoise=0.45)
EXPECTED_MESH_DEEPCACHE = {"flash_attention_fm": 300, "flash_attention_fm.sm90": 300,
                           "flash_attention": 2, "flash_attention.wide": 2}
# config 5 x2 (10 steps) under DeepCache N = 2: the base phase's 10 calls and
# phase 2's 10 view calls (2 a step) alternate full (104 flash calls: the
# UNet's 70, the ControlNet's 34) and cached (the ControlNet's 34: SDXL's
# level 0 has no transformer, so the UNet's cached pass has no attention),
# full on the even steps: 5 + 5 and, over phase 2's steps 0-4, 6 + 4; phase
# 2's 25 window calls run full
C5_DC_FLASH = 104 * 5 + 34 * 5 + 104 * 25 + 104 * 6 + 34 * 4
EXPECTED_CONFIG5_DC = {"flash_attention_fm": C5_DC_FLASH, "flash_attention_fm.sm90": C5_DC_FLASH}
# the train step (parallel/training.py) at SD1.5's full width and 512^2
# training size, fp32, TF32 off: batch 2 of [4, 64, 64] latents and [2, 77,
# 768] context, 3 steps at dp = tp = 1; each step runs the UNet's 10
# self-attentions at 4096 tokens (level 0, D = 40: 5) and 1024 (level 1, D =
# 80: 5) through #1's fp32 sm90 form and their gradients through the
# backward's fp32 tensor-core form (f32_sm90); remat runs each forward twice.
# dp = 2 x tp = 2 on cuda:0 x 4: one sample a replica, so #1 and the backward
# twice a step
TRAIN = dict(batch=2, latent=64, tokens=77, steps=3, lr=1e-5)
EXPECTED_TRAIN = {"flash_attention_fm_f32": 10, "flash_attention_fm_f32.sm90": 10,
                  "flash_attention_bwd": 10, "flash_attention_bwd.f32_sm90": 10}
EXPECTED_TRAIN_REMAT = dict(EXPECTED_TRAIN, **{"flash_attention_fm_f32": 20,
                                               "flash_attention_fm_f32.sm90": 20})
EXPECTED_TRAIN_DP2_TP2 = {k: 2 * v for k, v in EXPECTED_TRAIN.items()}
# the backward kernel's shapes (B, H, Lq, Lk, D): the train step's levels 0
# and 1, SD2 / SDXL's D = 64, the widest head, ragged Lq != Lk; the first
# BWD_SIMT_SHAPES also in the CUDA-core form (the earlier form's time)
BWD_SHAPES = [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80), (2, 10, 4096, 4096, 64),
              (2, 8, 576, 576, 160), (2, 8, 1000, 777, 40)]
BWD_SIMT_SHAPES = 2
# SD2.1-unCLIP (ViT-H: adm 2048) on config 2's canvas and sampler: heads of D =
# 64, 5 at level 0 and 10 at level 1, 10 flash calls a UNet call
EXPECTED_UNCLIP = {"flash_attention_fm": 200, "flash_attention_fm.sm90": 200,
                   "flash_attention": 1, "flash_attention.wide": 1}
# the full-width ESRGAN of the adapters phase (64 features, 23 blocks, grow 32)
ESRGAN = dict(num_feat=64, num_blocks=23, grow=32)
# #6's config-2 shapes [B, H, W, C, Co] above 640 channels, which only the
# NHWC UNet sends it: 1280 -> 1280 at 8 x 12 (11 a UNet call) and 16 x 24 (6),
# 640 -> 1280 at 16 x 24, 960 -> 640 and 1280 -> 640 at 32 x 48 (1 each)
NHWC_CONV_SHAPES = [(10, 8, 12, 1280, 1280), (10, 16, 24, 1280, 1280), (10, 16, 24, 640, 1280),
                    (10, 32, 48, 960, 640), (10, 32, 48, 1280, 640)]
MUFU_PER_SM_CLOCK = 16        # ex2 a clock per SM (H100)
N_SMS = 132
KERNELS = {
    "flash_attention_fm": dict(
        source="mdu_tpu_torch/csrc/flash_attention_fm.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:215",
        # UNet self-attention of config 2, levels 0 and 1; a ragged shape; the
        # VAE mid-block under MDU_FLASH=fm (the wide form); D = 13 (mma.sync);
        # the wide form ragged, and at D = 200 (off 64); D = 300 (wide_mma:
        # D % 8 != 0)
        # config 3's levels 0, 1, 2 (D = 160: the sm90 form's widest head)
        # config 4's region calls (batch 2) at levels 0, 1, 2
        # config 5's SDXL levels 1 and 2 (D = 64) at batch 4 and 2
        # config 2 under an AND of two prompts (phase prompts): 15 tiles a call
        shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40), (2, 1, 9600, 512),
                (1, 1, 700, 13), (1, 1, 1000, 512), (1, 2, 1000, 200), (1, 1, 500, 300),
                (10, 8, 9216, 40), (10, 8, 2304, 80), (10, 8, 576, 160),
                (2, 8, 9216, 40), (2, 8, 2304, 80), (2, 8, 576, 160),
                (4, 10, 4096, 64), (4, 20, 1024, 64), (2, 10, 4096, 64), (2, 20, 1024, 64),
                (15, 8, 6144, 40), (15, 8, 1536, 80),
                # SD2.1-unCLIP (D = 64) on config 2's canvas, levels 0 and 1
                (10, 5, 6144, 64), (10, 10, 1536, 64),
                # config 3 under image CFG: the 3-way sampling batches of 5 and 4
                # tiles, levels 0-2
                (15, 8, 9216, 40), (15, 8, 2304, 80), (15, 8, 576, 160),
                (12, 8, 9216, 40), (12, 8, 2304, 80), (12, 8, 576, 160)],
        # fp32: the same shapes (sm90, sm90, sm90, wide, simt)
        f32_shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40), (2, 1, 9600, 512),
                    (1, 1, 700, 13)]),
    "flash_attention": dict(
        source="mdu_tpu_torch/csrc/flash_attention.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:335",
        # VAE mid-block attention of config 2's decode; a ragged shape; D =
        # 200 (off 64); D = 300 (D % 8 != 0: the split-D mma.sync form); then
        # config 3's encoder (17424 tokens: a ragged last block) and decoder,
        # the 8K's encoder and decoder chunks and its statistics passes;
        # config 4's decoder mid-block (4 tiles of 118 latent); the streaming
        # VAE's groups
        shapes=[(2, 1, 9600, 512), (1, 1, 1000, 512), (1, 2, 1000, 200), (1, 1, 500, 300),
                (4, 1, 17424, 512), (16, 1, 7396, 512), (8, 1, 5184, 512), (8, 1, 7396, 512),
                (1, 1, 4096, 512), (4, 1, 13924, 512),
                # the streaming exact VAE's groups (phase stream): config 3's decode
                # in stream-device (groups of 2) and stream-host (3: 4 asked, the 4
                # GiB budget clamps it), its encode in stream-device (2) and
                # stream-host (1); the 8K's decode groups of 8 are the shape above
                (2, 1, 7396, 512), (3, 1, 7396, 512), (2, 1, 17424, 512), (1, 1, 17424, 512)],
        # fp32: the VAE's (wide form), ragged, config 2's level 0 as
        # MDU_FLASH=trans sends it (sm90), an odd D (simt)
        f32_shapes=[(2, 1, 9600, 512), (1, 1, 1000, 512), (10, 8, 6144, 40), (1, 1, 700, 13)]),
    "flash_attention_t": dict(
        source="mdu_tpu_torch/csrc/flash_attention_t.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:282",
        # under MDU_FLASH=trans: config 2's UNet self-attention; ragged; D = 13;
        # config 3's; config 4's region calls; config 5's
        shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40), (1, 1, 700, 13),
                (10, 8, 9216, 40), (10, 8, 2304, 80), (10, 8, 576, 160),
                (2, 8, 9216, 40), (2, 8, 2304, 80), (2, 8, 576, 160),
                (4, 10, 4096, 64), (4, 20, 1024, 64), (2, 10, 4096, 64), (2, 20, 1024, 64)]),
    "fused_group_norm": dict(
        source="mdu_tpu_torch/csrc/group_norm.cu",
        replaces="mdu_tpu/ops/pallas/group_norm.py:33",
        # [B, C, H, W], groups 32: what config 2 runs under MDU_FUSED_GN=1.
        # The transformer norms of levels 0, 1, 2 and the mid-block (with
        # norm_out, 120 / 100 / 100 / 20 launches per image under the four
        # flags); the widest ResBlock norm (2560 channels, a skip concat);
        # the largest ResBlock group (level 0's first up ResBlock, 960
        # channels with its skip: 360 KB a group in bf16); then a ragged H * W
        # (no 16-byte lines). Level 0 and the 960 channels take the cluster
        # form, the others (which fit L2) the two_read form.
        # Then config 3's level 0 in a sampling batch (cluster) and in an
        # inversion batch (two_read); config 4's region calls at levels 0 and
        # 1 (two_read). Config 5's: the UNet's norm_out at batch 4 (cluster),
        # the transformer norms of levels 1 and 2, an up-block concat of 2560.
        shapes=[(10, 320, 64, 96), (10, 640, 32, 48), (10, 1280, 16, 24), (10, 1280, 8, 12),
                (10, 2560, 16, 24), (10, 960, 64, 96), (1, 96, 7, 9), (10, 320, 96, 96),
                (4, 320, 96, 96), (2, 320, 96, 96), (2, 640, 48, 48),
                (4, 320, 128, 128), (4, 640, 64, 64), (4, 1280, 32, 32), (4, 2560, 32, 32)],
        # fp32 (a model built in fp32): level 0 (a cluster of 8); a group
        # past what a cluster holds (1.7 MB: the two_read form)
        f32_shapes=[(10, 320, 64, 96), (1, 416, 128, 256)]),
    "fused_tile_blend": dict(
        source="mdu_tpu_torch/csrc/tile_blend.cu",
        replaces="mdu_tpu/ops/pallas/fused_blend.py:92",
        # config 2's latent canvas 64 x 256, tiles 64 x 96 at overlap 48, B*C
        # = 4; then a ragged canvas; then config 3's MoD canvas 256 x 256,
        # tiles 96 at overlap 8, weighted by gaussian x 1 / sum(weights);
        # config 4's canvas 192 x 192, tiles 96 at overlap 48
        shapes=[(64, 256, 64, 96, 48, 4), (61, 97, 24, 24, 8, 3), (256, 256, 96, 96, 8, 4),
                (192, 192, 96, 96, 48, 4)]),
    "fused_conv3x3": dict(
        source="mdu_tpu_torch/csrc/conv3x3.cu",
        replaces="mdu_tpu/ops/pallas/conv3x3.py:96",
        # [B, H, W, C] -> Co: config 2's four ResBlock conv shapes (the first
        # two are its level-0 and level-1 convs); H and W off the warpgroup
        # form's 32 x 8 tile; Co off its 160 channels; odd H, W and C (the
        # mma.sync form, no 16-byte vectors); config 3's level-0 conv;
        # config 4's region calls at levels 0 and 1; config 5's levels 0 and 1
        # and its 320 -> 640 transition at batch 4, and levels 0 and 1 at 2;
        # config 2's NHWC shapes
        shapes=[(10, 64, 96, 320, 320), (10, 32, 48, 640, 640), (10, 64, 96, 640, 320),
                (10, 32, 48, 320, 640), (2, 45, 21, 320, 320), (2, 32, 48, 128, 200),
                (2, 7, 9, 12, 20), (10, 96, 96, 320, 320), (2, 96, 96, 320, 320),
                (2, 48, 48, 640, 640), (4, 128, 128, 320, 320), (4, 64, 64, 640, 640),
                (4, 64, 64, 320, 640), (2, 128, 128, 320, 320), (2, 64, 64, 640, 640),
                # config 2 under MDU_UNET_LAYOUT=NHWC: the convs above 640 channels
                # that the JAX planner fits (NCHW stops at 640)
                *NHWC_CONV_SHAPES],
        # fp32: config 2's four shapes (sm90); H, W and Co off the 32 x 8 x 80
        # tile (sm90); C = 12 (simt)
        f32_shapes=[(10, 64, 96, 320, 320), (10, 32, 48, 640, 640), (10, 64, 96, 640, 320),
                    (10, 32, 48, 320, 640), (2, 45, 21, 320, 200), (2, 7, 9, 12, 20)]),
}
# config-2-sized fp32 attention shapes, where the CUDA-core (simt) form runs
# beside the tensor-core form on the same inputs
F32_CONFIG2 = [(10, 8, 6144, 40), (10, 8, 1536, 80), (2, 1, 9600, 512)]
# the fp32 kernels: the TPU kernel they replace, and where they live
F32_KERNELS = {
    "flash_attention_fm_f32": ("flash_attention_fm",
                               "mdu_tpu_torch/csrc/flash_attention_f32_sm90.cuh"),
    "flash_attention_f32": ("flash_attention", "mdu_tpu_torch/csrc/flash_attention_f32_sm90.cuh"),
    "fused_conv3x3_f32": ("fused_conv3x3", "mdu_tpu_torch/csrc/conv3x3_f32_sm90.cuh"),
}


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, itemsize: int = 2, peak: float = None):
    """(bound ms, what bounds it) for the work and the bytes of one call."""
    peak = peak or (PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, H, L, D, itemsize=2, passes=1, peak=None):
    return bound(passes * 4.0 * B * H * L * L * D,   # QK^T and PV
                 4.0 * B * H * L * D * itemsize,     # q, k, v read; o written
                 itemsize, peak)


def sdpa_backend(q, k, v) -> str:
    """The backend that F.scaled_dot_product_attention picks for q, k, v."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        idx = int(torch._fused_sdp_choice(q, k, v))
    except (AttributeError, RuntimeError, TypeError) as exc:
        return f"unknown ({type(exc).__name__})"
    names = {int(b.value): n for n, b in SDPBackend.__members__.items()}
    return names.get(idx, str(idx))


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def device_ms(fn, iters: int):
    """Device time of one call: the durations of the kernels (and copies)
    that ``iters`` calls put on the card, summed by torch.profiler, over
    ``iters``. The host's time between launches does not count. None (not
    measured) when two profiled windows in a row show no device activity,
    as one cuDNN convolution did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                dt = getattr(evt, "device_time", None)
                total_us += evt.cuda_time if dt is None else dt
        if total_us > 0:
            return total_us / 1e3 / iters
    return None


def _record(name, shape, dtype, out, ref, err_plain, kernel_fn, plain_fn, lib_fn,
            bound_ms, bound_by, iters, plain_iters=3, **extra):
    """Check one kernel output against the fp32 plain version, time kernel,
    plain version and yardstick (CUDA events around a loop of calls; the
    kernel and the yardstick also on the device alone), emit a
    ``kernel_check`` line."""
    import torch

    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 * err_plain + 1e-3 if dtype == torch.bfloat16 else F32_TOL
    require(bool(torch.isfinite(out).all()), f"{name} {shape}: non-finite output")
    require(err <= tol, f"{name} {shape}: max abs err {err} > {tol}")
    ms = cuda_ms(kernel_fn, iters)
    dev_ms = device_ms(kernel_fn, iters)
    plain_ms = cuda_ms(plain_fn, plain_iters, warmup=1)
    lib_ms = cuda_ms(lib_fn, iters) if lib_fn is not None else None
    lib_dev_ms = device_ms(lib_fn, iters) if lib_fn is not None else None
    check = dict(shape=list(shape), dtype=_dtype_name(dtype), max_abs_err=err,
                 plain_err=err_plain, tol=tol, ms=ms,
                 device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                 library_device_ms=lib_dev_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)
    emit("kernel_check", name=name, **check)
    return check


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def check_attention(gen, summary):
    """bf16 flash kernels at every shape of KERNELS, fp32 at every
    ``f32_shapes``; #1 also with bf16_exp (MDU_FLASH=fm16) at its first
    shape, at D = 512 and at D = 13, and in fp32 at its first shape. Each
    line names the form the wrapper took, which must be the one its shape
    calls for. Where the warpgroup form runs at a config-2 shape, the earlier
    form (bf16: mma.sync; fp32: the CUDA-core simt form) is checked and timed
    on the same inputs beside it. fp32 lines bound the kernel by three TF32
    passes and give the fp32 FMA bound beside it, and time SDPA also under
    the efficient-attention backend."""
    import functools

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from mdu_tpu_torch.ops.kernels import flash

    clock_hz = max_sm_clock_hz()
    fns = {"flash_attention_fm": (flash.flash_attention_fm, flash.flash_attention_fm_plain),
           "flash_attention": (flash.flash_attention, flash.flash_attention_plain),
           "flash_attention_t": (flash.flash_attention_t, flash.flash_attention_t_plain)}

    def sdpa_efficient(q, k, v):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)

    for name, (kernel, plain) in fns.items():
        shapes = KERNELS[name]["shapes"]
        variants = [(torch.bfloat16, name, shapes, {})]
        if name != "flash_attention_t":        # its fp32 form is flash_attention_f32's
            f32_shapes = KERNELS[name]["f32_shapes"]
            variants.append((torch.float32, name + "_f32", f32_shapes, {}))
            # a sharp softmax (q x 3: scores of std 3, a large |O|) at the
            # main path's shapes, where a chain of truncating tensor-core
            # additions into O would miss the bar
            variants.append((torch.float32, name + "_f32_sharp", F32_CONFIG2, {"qscale": 3.0}))
        if name == "flash_attention_fm":
            variants.append((torch.bfloat16, name + "_bf16_exp",
                             [shapes[0], (2, 1, 9600, 512), (1, 1, 700, 13)],
                             {"bf16_exp": True}))
            # scores above smax = 2 (a few % of them) flattened
            variants.append((torch.bfloat16, name + "_clamp", [(2, 1, 9600, 512)],
                             {"smax": 2.0, "clamp": True}))
            variants.append((torch.float32, name + "_f32_bf16_exp", f32_shapes[:1],
                             {"bf16_exp": True}))
        for dtype, key, var_shapes, var_kw in variants:
            checks = []
            for shape in var_shapes:
                B, H, L, D = shape
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                kw = dict(var_kw)
                qscale = kw.pop("qscale", None)
                if qscale is not None:
                    q = q * qscale
                if kw.get("bf16_exp"):
                    # rounding the shifted score to bf16 (an ulp of 0.125 near
                    # -30) makes the function ambiguous wherever a score sits
                    # near a rounding boundary: q and k are small integers and
                    # the scale D^-0.5 rounded down to a power of two (scores
                    # of std 1.4-1.8, as random inputs give), so that every
                    # score is exact in any order and no rounding can go
                    # either way
                    q, k = (torch.randint(-2, 3, shape, generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    kw["scale"] = 2.0 ** -math.ceil(math.log2(D) / 2)
                kern = functools.partial(kernel, **kw)
                pl = functools.partial(plain, **kw)
                launches_before = dict(flash.LAUNCHES)
                out = kern(q, k, v)
                torch.cuda.synchronize()
                ref = pl(q.float(), k.float(), v.float())
                err_plain = ((pl(q, k, v).float() - ref).abs().max().item()
                             if dtype == torch.bfloat16 else 0.0)
                extra = {}
                if kw.get("bf16_exp"):
                    # the fp32 plain version with q.k summed in the reverse
                    # order of d: the same to the bit when no score is ambiguous
                    rev = pl(q.float().flip(-1).contiguous(), k.float().flip(-1).contiguous(),
                             v.float())
                    amb = (rev - ref).abs().max().item()
                    require(amb == 0.0, f"{key} {shape}: the plain version moves by {amb} "
                                        "when q.k is summed in reverse: a score is ambiguous")
                    extra.update(order_ambiguity=amb, scale=kw["scale"])
                    del rev
                big = L * L * B * H > 1e8
                iters = (20 if big else 50) if dtype == torch.bfloat16 else (3 if big else 10)
                lib_fn = lambda: F.scaled_dot_product_attention(q, k, v)
                mufu = B * H * L * L / (N_SMS * MUFU_PER_SM_CLOCK * clock_hz) * 1e3
                if dtype == torch.bfloat16 and name in flash.FORMS:
                    form = flash.bf16_form(name, q, k, v)
                    if D > flash.MMA_MAX_D:
                        want = ("wide" if D % 8 == 0 else
                                "wide_mma" if name == "flash_attention_fm" else "mma")
                    else:
                        want = "mma" if D % 8 or name == "flash_attention" else "sm90"
                    require(form == want, f"{key} {shape}: form {form}, expected {want}")
                    extra["form"] = form
                    earlier = {"sm90": "mma",
                               "wide": "wide_mma" if name == "flash_attention_fm" else "mma"}
                    if (form == "sm90" and shape in shapes[:2]) or (
                            form == "wide" and shape == (2, 1, 9600, 512)):
                        # the mma.sync form that config 2 took before, on the
                        # same inputs: held to the same bar, and timed
                        early = functools.partial(flash.launch_form, name, earlier[form],
                                                  q, k, v, **kw)
                        early_err = (early().float() - ref).abs().max().item()
                        require(early_err <= 2.0 * err_plain + 1e-3,
                                f"{key} {shape} {earlier[form]} form: max abs err {early_err}")
                        extra["earlier_max_abs_err"] = early_err
                        extra["earlier_ms"] = cuda_ms(early, iters)
                        extra["earlier_device_ms"] = device_ms(early, iters)
                        extra["earlier_form"] = earlier[form]
                    extra["mufu_floor_ms"] = mufu
                    extra["sm_clock_max_mhz"] = clock_hz / 1e6
                if dtype == torch.float32:
                    fname = name + "_f32"
                    form = flash.f32_form(fname, q, k, v)
                    want = ("sm90" if D <= flash.F32_SM90_MAX_D else "wide") if D % 4 == 0 \
                        else "simt"
                    require(form == want, f"{key} {shape}: form {form}, expected {want}")
                    require(flash.LAUNCHES[f"{fname}.{form}"]
                            == launches_before[f"{fname}.{form}"] + 1,
                            f"{key} {shape}: no launch counted under {fname}.{form}")
                    extra["form"] = form
                    if qscale is not None:
                        extra["qscale"] = qscale
                    elif shape in F32_CONFIG2:
                        # the CUDA-core form that fp32 took before, on the
                        # same inputs: held to the same bar, and timed
                        early = functools.partial(flash.launch_f32_form, fname, "simt", q, k, v,
                                                  **kw)
                        early_err = (early() - ref).abs().max().item()
                        require(early_err <= F32_TOL,
                                f"{key} {shape} simt form: max abs err {early_err}")
                        extra.update(earlier_form="simt", earlier_max_abs_err=early_err,
                                     earlier_ms=cuda_ms(early, iters),
                                     earlier_device_ms=device_ms(early, iters))
                    extra["fma_bound_ms"] = attention_bound(B, H, L, D, 4)[0]
                    extra["mufu_floor_ms"] = mufu
                    extra["sm_clock_max_mhz"] = clock_hz / 1e6
                    extra["bound_basis"] = "3 TF32 passes at 495 TFLOP/s"
                    extra["library_backend"] = sdpa_backend(q, k, v)
                    try:
                        sdpa_efficient(q, k, v)
                        eff = lambda: sdpa_efficient(q, k, v)
                        extra["library_efficient_ms"] = cuda_ms(eff, iters)
                        extra["library_efficient_device_ms"] = device_ms(eff, iters)
                    except RuntimeError as exc:            # the backend does not take it
                        extra["library_efficient_ms"] = None
                        extra["library_efficient_error"] = str(exc).splitlines()[0][:200]
                    bound_ms, bound_by = attention_bound(B, H, L, D, 4, passes=3,
                                                         peak=PEAK_TF32_FLOPS)
                else:
                    bound_ms, bound_by = attention_bound(B, H, L, D, q.element_size())
                checks.append(_record(
                    key, shape, dtype, out, ref, err_plain, lambda: kern(q, k, v),
                    lambda: pl(q, k, v), lib_fn, bound_ms, bound_by, iters, **extra))
                del q, k, v, out, ref
            summary[key] = checks


def check_group_norm(gen, summary):
    """bf16 at every shape of KERNELS, fp32 at every ``f32_shapes``. Each line
    names the form that ``gn_plan`` picks, whose launch counter must move; at
    config 2's shapes the other form runs on the same inputs too (where a
    group fits a cluster), held to the same bar and timed (``other_*``).
    Then a constant group: its variance clamps at 0, and the output is the
    bias."""
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import LAUNCHES, fused_group_norm, fused_group_norm_plain
    from mdu_tpu_torch.ops.kernels import group_norm as gn_mod

    G, eps = 32, 1e-6
    spec = KERNELS["fused_group_norm"]
    runs = ([(s, torch.bfloat16) for s in spec["shapes"]]
            + [(s, torch.float32) for s in spec["f32_shapes"]])
    checks = []
    for shape, dtype in runs:
        B, C, H, W = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        w = (1 + 0.2 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        b = (0.2 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        form, cluster, part = gn_mod.gn_plan(B, C, G, H, W, x.element_size())
        before = LAUNCHES[f"fused_group_norm.{form}"]
        out = fused_group_norm(x, G, w, b, eps)
        torch.cuda.synchronize()
        require(LAUNCHES[f"fused_group_norm.{form}"] == before + 1,
                f"fused_group_norm {shape}: no launch of its {form} form")
        ref = fused_group_norm_plain(x.float(), G, w.float(), b.float(), eps)
        err_plain = ((fused_group_norm_plain(x, G, w, b, eps).float() - ref).abs().max().item()
                     if dtype == torch.bfloat16 else 0.0)
        tol = 2.0 * err_plain + 1e-3 if dtype == torch.bfloat16 else F32_TOL
        extra = {"form": form, "cluster": cluster, "part": part}
        other = "two_read" if form == "cluster" else "cluster"
        if B == 10 and gn_mod.cluster_split(C // G * H * W, x.element_size()):
            alt = lambda: gn_mod.launch_form(other, x, G, w, b, eps)
            alt_err = (alt().float() - ref).abs().max().item()
            require(alt_err <= tol, f"fused_group_norm {shape} {other} form: max abs err "
                                    f"{alt_err}")
            extra.update(other_form=other, other_max_abs_err=alt_err,
                         other_ms=cuda_ms(alt, 50), other_device_ms=device_ms(alt, 50))
        isz = x.element_size()
        bound_ms, bound_by = bound(8.0 * x.numel(), 2.0 * x.numel() * isz + 2.0 * C * isz, isz)
        checks.append(_record(
            "fused_group_norm", shape, dtype, out, ref, err_plain,
            lambda: fused_group_norm(x, G, w, b, eps),
            lambda: fused_group_norm_plain(x, G, w, b, eps),
            lambda: F.group_norm(x, G, w, b, eps), bound_ms, bound_by, 50,
            plain_iters=1 if x.numel() > 5e7 else 3, **extra))
        # a constant first group: var = 0 exactly, so the output is the bias
        x[:, :C // G] = 5.0
        out = fused_group_norm(x, G, w, b, eps)
        first = out[:, :C // G].float()
        require(bool(torch.isfinite(out).all()) and bool(
            (first == b[:C // G].float()[None, :, None, None]).all()),
            f"fused_group_norm {shape}: a constant group does not give the bias")
        del x, out, ref
    summary["fused_group_norm"] = checks


def index_add_blend(h, w, bboxes, BC, device):
    """The yardstick of #5: one ``index_add_`` of the flat tiles [T, BC, th,
    tw] into the flat canvas [BC, h, w], with the index built once per plan.
    Returns (index, call(tiles, canvas))."""
    import torch

    idx = []
    for b in bboxes:
        ys = torch.arange(b.y, b.y + b.h, device=device)[:, None]
        xs = torch.arange(b.x, b.x + b.w, device=device)[None, :]
        pix = (ys * w + xs).reshape(1, -1)
        chans = torch.arange(BC, device=device)[:, None] * (h * w)
        idx.append((chans + pix).reshape(-1))
    index = torch.cat(idx)

    def add(tiles, canvas):
        canvas.view(-1).index_add_(0, index, tiles.reshape(-1))
        return canvas

    return index, add


def check_tile_blend(gen, summary):
    """The config-2 canvas (tiles fp32, as the latents are) with normalize
    False (what the scheduler asks) and True; bf16 tiles; a ragged canvas;
    config 3's Mixture of Diffusers canvas, its tiles weighted by gaussian x
    1 / sum(weights), normalize False; config 4's MultiDiffusion canvas,
    normalize False. The first line also times the launch
    floor (``floor_ms``, ``floor_device_ms``): an empty kernel on #5's grid.
    The yardstick is ``index_add_`` into the flat canvas (``index_add_blend``),
    on the fp32 canvases the scheduler sends with normalize False."""
    import torch

    from mdu_tpu_torch.config import Method
    from mdu_tpu_torch.ops.kernels import BlendTable, fused_tile_blend, fused_tile_blend_plain
    from mdu_tpu_torch.ops.kernels.tile_blend import tile_blend_floor
    from mdu_tpu_torch.tiling.schedulers import mod_tile_weights, plan_tiled_diffusion
    from mdu_tpu_torch.utils.grid import paint_count, split_grid

    checks = []
    specs = KERNELS["fused_tile_blend"]["shapes"]
    for (h, w, th, tw, ov, BC), dtype, normalize in (
            (specs[0], torch.float32, False), (specs[0], torch.float32, True),
            (specs[0], torch.bfloat16, False), (specs[1], torch.float32, True),
            (specs[2], torch.float32, False), (specs[3], torch.float32, False)):
        mod = (h, w) == specs[2][:2]
        tiles_scale = None
        if mod:
            plan = plan_tiled_diffusion(Method.MIX_DIFF, h, w, th, tw, ov, tile_bs=8)
            bbs = list(plan.bboxes)
            wts = torch.as_tensor(plan.weights[0, 0], device="cuda")
            tiles_scale = torch.as_tensor(mod_tile_weights(plan), device="cuda")[:, None]
        else:
            bbs = split_grid(w, h, tw, th, ov)
            wts = torch.as_tensor(paint_count(w, h, bbs)[0, 0], device="cuda")
        table = BlendTable(h, w, bbs)
        tiles = torch.randn(len(bbs), BC, th, tw, generator=gen, device="cuda")
        if tiles_scale is not None:
            tiles = tiles * tiles_scale
        tiles = tiles.to(dtype)
        out = fused_tile_blend(tiles, wts, h, w, bbs, normalize, table)
        torch.cuda.synchronize()
        ref = fused_tile_blend_plain(tiles.cpu().float(), wts.cpu(), h, w, bbs, normalize,
                                     table).cuda()
        err_plain = ((fused_tile_blend_plain(tiles.cpu(), wts.cpu(), h, w, bbs, normalize,
                                             table).cuda().float() - ref).abs().max().item()
                     if dtype == torch.bfloat16 else 0.0)
        isz = tiles.element_size()
        nbytes = tiles.numel() * isz + BC * h * w * isz + (wts.numel() * 4 if normalize else 0)
        bound_ms, bound_by = bound(float(tiles.numel()), nbytes, isz)
        extra = {"mod_weighted": mod}
        lib_fn = None
        if dtype == torch.float32 and not normalize:
            _, add = index_add_blend(h, w, bbs, BC, "cuda")
            lib_out = add(tiles, torch.zeros(BC, h, w, device="cuda"))
            lib_err = (lib_out - ref).abs().max().item()
            require(lib_err <= F32_TOL, f"index_add_ yardstick {(h, w)}: max abs err {lib_err}")
            canvas = torch.zeros(BC, h, w, device="cuda")
            lib_fn = lambda: add(tiles, canvas)
            extra.update(library="index_add_ into the flat canvas", library_max_abs_err=lib_err)
        if not checks:
            # the launch floor: an empty kernel on the same grid, through the
            # same checks and launch path
            floor = lambda: tile_blend_floor(tiles, wts, h, w, bbs, normalize, table)
            extra.update(floor_ms=cuda_ms(floor, 200), floor_device_ms=device_ms(floor, 200))
        checks.append(_record(
            "fused_tile_blend", (len(bbs), BC, th, tw, h, w), dtype, out, ref, err_plain,
            lambda: fused_tile_blend(tiles, wts, h, w, bbs, normalize, table),
            lambda: fused_tile_blend_plain(tiles, wts, h, w, bbs, normalize, table),
            lib_fn, bound_ms, bound_by, 200, normalize=normalize, **extra))
    summary["fused_tile_blend"] = checks


def check_conv(gen, summary):
    """bf16 at every shape of KERNELS with and without fuse_act; fp32 at every
    ``f32_shapes`` with fuse_act and at the first without. Each line names
    the form the wrapper took, which must be the one its shape calls for; at
    config 2's four shapes the earlier form (bf16: mma.sync; fp32: the
    CUDA-core simt form) runs on the same inputs too, held to the same bar
    and timed (``earlier_ms``). fp32 lines bound the kernel by three TF32
    passes and give the fp32 FMA bound beside it. The yardstick is cuDNN's
    conv alone, on the pre-activated channels-last input (TF32 off)."""
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import (fused_conv3x3, fused_conv3x3_plain,
                                           pack_conv3x3_weight)
    from mdu_tpu_torch.ops.kernels import conv3x3 as conv_mod

    shapes = KERNELS["fused_conv3x3"]["shapes"]
    f32_shapes = KERNELS["fused_conv3x3"]["f32_shapes"]
    runs = [(s, torch.bfloat16, act, "fused_conv3x3") for s in shapes for act in (True, False)]
    runs += [(s, torch.float32, True, "fused_conv3x3_f32") for s in f32_shapes]
    runs.append((f32_shapes[0], torch.float32, False, "fused_conv3x3_f32"))
    checks = {"fused_conv3x3": [], "fused_conv3x3_f32": []}
    for (B, H, W, C, Co), dtype, act, key in runs:
        bf16 = dtype == torch.bfloat16
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(3, 3, C, Co, generator=gen, device="cuda") / (9 * C) ** 0.5).to(dtype)
        a = 1 + 0.5 * torch.randn(B, C, generator=gen, device="cuda")
        sh = 0.2 * torch.randn(B, C, generator=gen, device="cuda")
        packed = pack_conv3x3_weight(w)
        out = fused_conv3x3(x, w, a, sh, fuse_act=act, packed=packed)
        torch.cuda.synchronize()
        ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=act)
        err_plain = ((fused_conv3x3_plain(x, w, a, sh, fuse_act=act).float() - ref)
                     .abs().max().item() if bf16 else 0.0)
        tol = 2.0 * err_plain + 1e-3 if bf16 else F32_TOL
        iters = 20 if bf16 else 5
        extra = {}
        ops = (x, packed, a, sh) if act else (x, packed)
        if bf16:
            form = conv_mod.conv_form(*ops)
            want = "sm90" if C % conv_mod.SM90_CHUNK == 0 and Co % 8 == 0 else "mma"
            earlier = "mma"
        else:
            form = conv_mod.conv_f32_form(*ops)
            want = "sm90" if C % conv_mod.F32_SM90_CHUNK == 0 and Co % 8 == 0 else "simt"
            earlier = "simt"
        require(form == want, f"{key} {(B, H, W, C, Co)}: form {form}, expected {want}")
        extra["form"] = form
        if (B, H, W, C, Co) in shapes[:4] and form != earlier:
            # the form that config 2 took before, on the same inputs: held to
            # the same bar, and timed
            launch = conv_mod.launch_form if bf16 else conv_mod.launch_f32_form
            early = lambda: launch(earlier, x, packed, a, sh, act)
            early_err = (early().float() - ref).abs().max().item()
            require(early_err <= tol,
                    f"{key} {(B, H, W, C, Co)} {earlier} form: max abs err {early_err}")
            extra.update(earlier_form=earlier, earlier_max_abs_err=early_err,
                         earlier_ms=cuda_ms(early, iters),
                         earlier_device_ms=device_ms(early, iters))
        if act:
            xf = x.float() * a[:, None, None, :] + sh[:, None, None, :]
            xa = (xf * torch.sigmoid(xf)).to(dtype)
        else:
            xa = x
        xa = xa.permute(0, 3, 1, 2)                      # NCHW view, channels-last memory
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        isz = x.element_size()
        flops = 2.0 * B * H * W * 9 * C * Co
        nbytes = (x.numel() + w.numel() + B * H * W * Co) * isz + (2 * B * C * 4 if act else 0)
        if bf16:
            bound_ms, bound_by = bound(flops, nbytes, isz)
        else:
            extra["fma_bound_ms"] = bound(flops, nbytes, isz)[0]
            extra["bound_basis"] = "3 TF32 passes at 495 TFLOP/s"
            bound_ms, bound_by = bound(3 * flops, nbytes, isz, PEAK_TF32_FLOPS)
        checks[key].append(_record(
            key, (B, H, W, C, Co), dtype, out, ref, err_plain,
            lambda: fused_conv3x3(x, w, a, sh, fuse_act=act, packed=packed),
            lambda: fused_conv3x3_plain(x, w, a, sh, fuse_act=act),
            lambda: F.conv2d(xa, w_oihw, padding=1), bound_ms, bound_by, iters, fuse_act=act,
            library="F.conv2d on the pre-activated input (conv alone)", **extra))
        del x, w, packed, out, ref, xa, w_oihw
    summary.update(checks)


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    check_attention(gen, summary)
    check_group_norm(gen, summary)
    check_tile_blend(gen, summary)
    check_conv(gen, summary)
    check_attention_bwd(gen, summary)
    return summary


@contextlib.contextmanager
def flags_set(flags):
    """The kernel flags set in ``os.environ`` for a ``with`` block (the port
    reads them at call time), and restored after it."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tiny_pipeline(device: str, dtype, unet_config=None):
    """The tiny pipeline on ``device`` (``unet_config``: the tiny config by
    default) with random weights drawn on the CPU (so that both devices get
    the same weights), and a cond and an uncond: returns (pipe, cond, uncond,
    the CPU generator that drew them)."""
    import torch

    from mdu_tpu_torch import DiffusionPipeline
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, random_state_dict,
                                      tiny_unet_config, tiny_vae_config)

    unet = UNet2DCondition(unet_config or tiny_unet_config(), dtype=dtype)
    vae = AutoencoderKL(tiny_vae_config(), dtype=dtype)
    unet.load_state_dict(random_state_dict(unet, 0, dtype, device="cpu"))
    vae.load_state_dict(random_state_dict(vae, 1, dtype, device="cpu"))
    pipe = DiffusionPipeline(unet, vae, device=device)
    gen = torch.Generator().manual_seed(5)
    c = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
    u = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
    return pipe, c, u, gen


def _tiny_run(device: str, dtype):
    """Tiny MultiDiffusion txt2img + exact tiled decode at a size whose UNet
    level-0 and VAE mid-block attention reach the flash kernels on the card:
    returns (latents, image) on the CPU in fp32."""
    import torch

    from mdu_tpu_torch import SamplerConfig, TiledDiffusionConfig, TiledVAEConfig

    pipe, c, u, gen = _tiny_pipeline(device, dtype)
    noise = torch.randn(1, 4, 32, 64, generator=gen)
    res = pipe._txt2img_from_noise(
        noise, c, u, SamplerConfig(steps=3), 0,
        TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16, tile_bs=3),
        decode=False)
    img = pipe._decode_tensor(res.latents, TiledVAEConfig(
        decoder_tile_size=16, fast_decoder=False))
    return res.latents.float().cpu(), img.float().cpu()


def _tiny_img2img(device: str, dtype):
    """Tiny img2img at a size whose UNet level 0 (32 x 32 tiles: 1024 tokens)
    and both VAE mid-blocks (the encoder's 224 px tiles and its 192 px
    statistics pass; the decoder's 54-latent tiles and its 24-latent
    statistics pass) reach the flash kernels on the card: a 512 x 512 uint8
    image (upscaler None, so that both devices quantise the same image for
    the renoise mask), Mixture of Diffusers (9 tiles of 32 in 3 batches),
    noise inversion (3 steps, renoise 1), the exact tiled encode (tile 192: 9
    tiles) and decode (tile 24: 4 tiles); then the fast encode with
    ``color_fix`` of the same image and the fast decode of the latents
    (``tile_batch`` 2). Returns (latents, image, fast moments, fast image) on
    the CPU in fp32."""
    import numpy as np
    import torch

    from mdu_tpu_torch import Method, SamplerConfig, TiledDiffusionConfig, TiledVAEConfig
    from mdu_tpu_torch.utils.image import image_to_tensor

    pipe, c, u, gen = _tiny_pipeline(device, dtype)
    img = (np.random.default_rng(6).random((512, 512, 3)) * 255).astype(np.uint8)
    enc_noise = torch.randn(1, 4, 64, 64, generator=gen).to(dtype)
    noise = torch.randn(1, 4, 64, 64, generator=gen)
    td = TiledDiffusionConfig(method=Method.MIX_DIFF, tile_w=32, tile_h=32, overlap=8,
                              tile_bs=3, noise_inverse=True, noise_inverse_steps=3,
                              noise_inverse_renoise_kernel=16)
    exact = TiledVAEConfig(encoder_tile_size=192, decoder_tile_size=24,
                           fast_encoder=False, fast_decoder=False)
    fast = TiledVAEConfig(encoder_tile_size=192, decoder_tile_size=24, color_fix=True,
                          tile_batch=2)
    res = pipe._img2img_from_noise(
        img, enc_noise, noise, c, u,
        SamplerConfig(steps=4, cfg_scale=7.0, denoising_strength=0.75), 0, td, exact,
        decode=False)
    image = pipe._decode_tensor(res.latents, exact)
    moments = pipe._encode(image_to_tensor(img), fast)
    fast_image = pipe._decode_tensor(res.latents, fast)
    return tuple(t.float().cpu() for t in (res.latents, image, moments, fast_image))


def _tiny_regional(method):
    """Tiny regional txt2img under ``method`` (the 32 x 64 latent of
    ``_tiny_run``; tiles of 32 at overlap 16 in one batch of 3), a BACKGROUND
    region over the left half (32 x 32 latent: 1024 tokens) and a feathered
    FOREGROUND one (16 x 32: 512 tokens), each with its own (cond, uncond),
    Euler 3 steps, then the exact tiled decode. The base noise and the
    regions' patches are drawn and composed on the CPU. Returns
    ``run(device, dtype) -> (latents, image)`` on the CPU in fp32."""

    def run(device, dtype):
        import torch

        from mdu_tpu_torch import SamplerConfig, TiledDiffusionConfig, TiledVAEConfig
        from mdu_tpu_torch.tiling.regions import compose_region_noise
        from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec

        pipe, c, u, gen = _tiny_pipeline(device, dtype)
        rc = [{"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
              for _ in range(3)]
        regions = [RegionSpec(0.0, 0.0, 0.5, 1.0, seed=31),
                   RegionSpec(0.25, 0.25, 0.5, 0.5, blend_mode=BlendMode.FOREGROUND,
                              feather_ratio=0.3, seed=32)]
        noise = compose_region_noise(torch.randn(1, 4, 32, 64, generator=gen),
                                     [r.to_bbox(64, 32) for r in regions], [31, 32])
        td = TiledDiffusionConfig(method=method, tile_w=32, tile_h=32, overlap=16, tile_bs=3,
                                  regions=regions)
        res = pipe._txt2img_from_noise(noise, c, u, SamplerConfig(steps=3), 0, td, decode=False,
                                       region_conds=[(rc[0], rc[1]), (rc[2], u)],
                                       region_seeds=[31, 32])
        img = pipe._decode_tensor(res.latents, TiledVAEConfig(decoder_tile_size=16,
                                                              fast_decoder=False))
        return res.latents.float().cpu(), img.float().cpu()

    return run


def _tiny_sdxl_pipeline(device: str, dtype):
    """The tiny SDXL UNet and a ControlNet of its config, with random weights
    drawn on the CPU and the ControlNet's zero gates filled with random
    values (so that a wrong residual path shows), and the tiny VAE: returns
    (pipe, cond, uncond, the CPU generator that drew them). The cond has a
    vector and a nonzero 384 x 384 hint; the uncond zero text."""
    import torch

    from mdu_tpu_torch import DiffusionPipeline
    from mdu_tpu_torch.models import (AutoencoderKL, ControlNet, UNet2DCondition,
                                      random_state_dict, tiny_sdxl_unet_config,
                                      tiny_vae_config)

    cfg = tiny_sdxl_unet_config()
    unet, cn = UNet2DCondition(cfg, dtype=dtype), ControlNet(cfg, dtype=dtype)
    vae = AutoencoderKL(tiny_vae_config(), dtype=dtype)
    gen = torch.Generator().manual_seed(11)
    cn_sd = random_state_dict(cn, 2, dtype, device="cpu")
    for name in cn_sd:
        if name.split(".")[0].startswith("zero") or name.startswith("cond_embedding.conv_out"):
            cn_sd[name] = (torch.randn(cn_sd[name].shape, generator=gen) * 0.3).to(dtype)
    unet.load_state_dict(random_state_dict(unet, 0, dtype, device="cpu"))
    cn.load_state_dict(cn_sd)
    vae.load_state_dict(random_state_dict(vae, 1, dtype, device="cpu"))
    pipe = DiffusionPipeline(unet, vae, device=device, controlnet=cn)
    ctx = (torch.randn(1, 7, 16, generator=gen) * 0.5).to(dtype)
    vec = torch.randn(1, 16, generator=gen).to(dtype)
    hint = torch.rand(1, 3, 384, 384, generator=gen)
    c = {"crossattn": ctx, "vector": vec, "control": [hint]}
    u = {"crossattn": torch.zeros_like(ctx), "vector": vec, "control": [hint]}
    return pipe, c, u, gen


def _tiny_demofusion(device: str, dtype):
    """DemoFusion x2 on the tiny SDXL UNet + ControlNet: a 48 x 48 latent
    (576 tokens at UNet level 1: a flash kernel on the card) to 96 x 96,
    windows of 48 at overlap 24 in batches of 4 (9 windows, jitter drawn
    from the seed), the 4 dilated views in batches of 2 with the gaussian
    filter, Euler 3 steps at denoise 0.6; the base and phase noise drawn on
    the CPU. Returns (phase 1 latent, phase 2 latent) on the CPU in fp32."""
    import torch

    from mdu_tpu_torch import DemoFusionConfig, SamplerConfig

    pipe, c, u, gen = _tiny_sdxl_pipeline(device, dtype)
    base = torch.randn(1, 4, 48, 48, generator=gen)
    phase = torch.randn(1, 4, 96, 96, generator=gen)
    cfg = DemoFusionConfig(window_size=48, overlap=24, tile_bs=4, tile_bs_g=2, scale_factor=2)
    res = pipe._demofusion_from_noise(base, [phase], c, u, 384, 384, cfg,
                                      SamplerConfig(steps=3, denoising_strength=0.6), seed=3,
                                      decode=False)
    return tuple(p.float().cpu() for p in res.phase_latents)


# the reference phase's samplers: every sampler, a Karras name, Euler with churn
# the tiny config's first level and its mid-block (the reference samplers' UNet)
TINY_TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                       transformer_layers=(1, 0), norm_num_groups=4)
TINY_SAMPLERS = [(name, {}) for name in (
    "Euler", "Euler a", "Heun", "DPM2", "DPM2 a", "DPM++ 2M", "DPM++ 2S a", "DPM++ SDE",
    "DPM++ 2M SDE", "DPM fast", "DPM adaptive", "DDIM", "LMS", "PLMS", "Restart",
    "DPM++ 2M Karras")] + [("Euler", {"s_churn": 1.0, "s_tmin": 0.5, "s_tmax": 10.0})]


def _tiny_sampler(name, churn, decisions, factors):
    """The tiny pipeline on a two-level UNet (the tiny config's first level
    and its mid-block: what a sampler's arithmetic needs, at half the cost)
    untiled on a 32 x 32 latent (1024 tokens at UNet level 0, a
    flash kernel on the card) under sampler ``name``, 3 steps,
    the samplers' noise drawn from a CPU generator (the same draws on both
    devices). DPM adaptive's accept / reject decisions go to
    ``decisions[(device, dtype)]`` and the controller's factor of each to
    ``factors[(device, dtype)]``. Returns ``run(device, dtype) -> (latents,)``."""

    def run(device, dtype):
        import functools

        import torch

        from mdu_tpu_torch import SamplerConfig
        from mdu_tpu_torch.samplers import samplers

        from mdu_tpu_torch.models.unet import UNetConfig

        pipe, c, u, gen = _tiny_pipeline(device, dtype, UNetConfig(**TINY_TWO_LEVELS))
        noise = torch.randn(1, 4, 32, 32, generator=gen)
        adaptive = samplers.SAMPLERS["DPM adaptive"]
        key = (device, _dtype_name(dtype))
        samplers.SAMPLERS["DPM adaptive"] = functools.partial(
            adaptive, decisions=decisions.setdefault(key, []),
            factors=factors.setdefault(key, []))
        try:
            res = pipe._txt2img_from_noise(noise, c, u, SamplerConfig(name=name, steps=3, **churn),
                                           0, None, decode=False,
                                           sampler_noise=torch.Generator().manual_seed(9))
        finally:
            samplers.SAMPLERS["DPM adaptive"] = adaptive
        return (res.latents.float().cpu(),)

    return run


# the reference phases' CPU runs go to worker processes while the card runs
# its own: they were most of those phases' time (PR 14: 80 % of 227-317 s)
# and 4 workers made the phase slower than 3 (145.3 s against 124.7 s)
CPU_REF_WORKERS = 3
CPU_REF_THREADS = 2           # torch threads in each worker


def _cpu_worker_init():
    """A worker's start: its torch threads, and no kernel flag inherited from
    the parent (each job sets its own)."""
    import torch

    torch.set_num_threads(CPU_REF_THREADS)
    for flag in FLAGS:
        os.environ.pop(flag, None)


def _as_numpy(x):
    if isinstance(x, dict):
        return {k: _as_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_as_numpy(v) for v in x)
    return x.detach().float().cpu().numpy()


def _as_torch(x):
    import torch

    if isinstance(x, dict):
        return {k: _as_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_as_torch(v) for v in x)
    return torch.from_numpy(x)


def _cpu_refs(spec, flags):
    """The CPU fp32 and bf16 outputs of one tiny run under ``flags``, with
    the accept / reject decisions and factors DPM adaptive appended, in a
    worker process or in this one. ``spec`` is (the name of a run in this
    module, None) or (the name of a factory of one, its arguments);
    ``_tiny_sampler`` gets the decision lists too. The outputs come back as
    numpy arrays."""
    import torch

    name, args = spec
    decisions, factors = {}, {}
    fn = globals()[name]
    with flags_set(flags):
        if name == "_tiny_sampler":
            run = fn(*args, decisions, factors)
        else:
            run = fn if args is None else fn(*args)
        t0 = time.perf_counter()
        outs = [run("cpu", d) for d in (torch.float32, torch.bfloat16)]
    return _as_numpy(outs), decisions, factors, time.perf_counter() - t0


@contextlib.contextmanager
def _cpu_pool():
    """``CPU_REF_WORKERS`` spawned worker processes for ``_cpu_refs``, shut
    down (pending jobs cancelled) when the block ends."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_REF_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init)
    try:
        yield pool
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _submit_refs(pool, jobs):
    """``jobs``: (spec, flags) pairs; returns a getter of each job's
    ``_cpu_refs`` result: from the pool, or computed here without one."""
    futures = [pool.submit(_cpu_refs, spec, flags) if pool is not None else None
               for spec, flags in jobs]

    def get(i):
        out = futures[i].result() if futures[i] is not None else _cpu_refs(*jobs[i])
        return (_as_torch(out[0]),) + tuple(out[1:])

    return get


def _hold_to_cpu(label, run, parts, must_launch, dtypes=None, off_path=(), cpu=None):
    """``run`` on the card against the CPU in each dtype (fp32 within 1e-4 of
    the largest CPU value; bf16 within 2x the CPU bf16 run's own error
    against the CPU fp32 run plus 1e-3 of it); each card run must launch
    ``must_launch[dtype]``, but for the kernels ``off_path`` names. ``cpu``:
    ((the CPU fp32 run, the CPU bf16 run), seconds) when they ran elsewhere
    (``_cpu_refs``). Returns the ``reference`` lines' fields by dtype."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    if cpu is None:
        t0 = time.perf_counter()
        ref = run("cpu", torch.float32)
        ref_bf16 = run("cpu", torch.bfloat16)
        cpu_s = time.perf_counter() - t0
    else:
        (ref, ref_bf16), cpu_s = cpu
    out = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        reset_launches()
        t0 = time.perf_counter()
        got = run("cuda", dtype)
        card_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        for key in must_launch[dtype]:
            if key not in off_path:
                require(launches[key] > 0, f"{label} {dtype} launched no {key}")
        fields = {"launches": launches, "cpu_s": cpu_s, "card_s": card_s}
        for i, part in enumerate(parts):
            scale = ref[i].abs().max().item()
            err = (got[i] - ref[i]).abs().max().item()
            if dtype == torch.float32:
                tol = 1e-4 * scale
            else:
                tol = 2.0 * (ref_bf16[i] - ref[i]).abs().max().item() + 1e-3 * scale
            require(bool(torch.isfinite(got[i]).all()), f"{label} {dtype} {part}: non-finite")
            require(err <= tol, f"{label} {dtype} {part}: max abs err {err} > {tol}")
            fields.update({f"{part}_max_abs_err": err, f"{part}_tol": tol})
        out[dtype] = fields
    return out


def _reference_runs():
    """``phase_reference``'s flag settings with the kernels each must launch,
    its pipelines, and the CPU jobs (``_cpu_refs`` specs and flags) in the
    order the phase reads them."""
    import torch

    from mdu_tpu_torch.config import Method

    runs = [({}, {torch.float32: ["flash_attention_fm_f32", "flash_attention_fm_f32.sm90"],
                  torch.bfloat16: ["flash_attention_fm"]}),
            (FLAGS, {torch.float32: ["flash_attention_f32", "flash_attention_f32.sm90",
                                     "fused_group_norm", "fused_conv3x3_f32",
                                     "fused_tile_blend"],
                     torch.bfloat16: ["flash_attention_t", "fused_group_norm",
                                      "fused_conv3x3", "fused_tile_blend"]})]
    # (label, the run's spec for _cpu_refs, parts, kernels off its path)
    pipelines = (("DemoFusion SDXL + ControlNet", ("_tiny_demofusion", None),
                  ("phase1_latent", "latent"), ("fused_tile_blend",)),
                 ("txt2img", ("_tiny_run", None), ("latent", "image"), ()),
                 ("img2img", ("_tiny_img2img", None), ("latent", "image", "fast_moments",
                                                       "fast_image"), ()),
                 ("regional MultiDiffusion", ("_tiny_regional", (Method.MULTI_DIFF,)),
                  ("latent", "image"), ()),
                 ("regional Mixture of Diffusers", ("_tiny_regional", (Method.MIX_DIFF,)),
                  ("latent", "image"), ()))
    jobs = [(spec, flags) for flags, _ in runs for _, spec, _, _ in pipelines]
    jobs += [(("_tiny_sampler", (name, churn)), {}) for name, churn in TINY_SAMPLERS]
    return runs, pipelines, jobs


def phase_reference(get=None):
    """The tiny txt2img, img2img and regional txt2img pipelines on the card
    against the same pipelines on the CPU (plain versions): in fp32 within
    1e-4 of the largest CPU value; in bf16 within 2x the CPU bf16 run's own
    error against the CPU fp32 run plus 1e-3 of the largest value. With no
    flag each card run must launch its fm kernel (in fp32 its sm90 form: the
    heads are D = 4 and 16); with the four flags, each flagged kernel (but
    #5 in DemoFusion, which fuses its windows itself). The same for the tiny
    SDXL + ControlNet DemoFusion x2 (``_tiny_demofusion``). Then the tiny pipeline under every
    sampler, with no flag, held the same way; DPM adaptive's decisions on
    the card must equal the CPU's in fp32. In bf16 the first decision where
    the card and the CPU differ is printed with both devices' factors, the
    0.81 they are held against, and the yardstick of bf16's rounding: the
    largest gap between the CPU's bf16 and fp32 factors over the decisions
    both dtypes take alike up to that one (``within_bf16_rounding``: the
    card's gap at most twice that, the form of the bf16 bar). ``get`` reads
    the CPU runs (``_submit_refs`` of ``_reference_runs``' jobs, submitted to
    the pool before the kernel checks); without it they run here."""
    import torch

    runs, pipelines, jobs = _reference_runs()
    get = get or _submit_refs(None, jobs)
    done = 0
    for flags, must_launch in runs:
        with flags_set(flags):
            for pipeline, (fn, args), parts, off_path in pipelines:
                label = f"tiny {pipeline} (flags {flags})"
                run = globals()[fn] if args is None else globals()[fn](*args)
                refs, _, _, cpu_s = get(done)
                done += 1
                for dtype, fields in _hold_to_cpu(label, run, parts, must_launch,
                                                  off_path=off_path,
                                                  cpu=(refs, cpu_s)).items():
                    emit("reference", dtype=_dtype_name(dtype), pipeline=pipeline, flags=flags,
                         **fields)
    must_launch = runs[0][1]
    for name, churn in TINY_SAMPLERS:
        refs, decisions, factors, cpu_s = get(done)
        done += 1
        fields = _hold_to_cpu(f"tiny sampler {name} {churn}",
                              _tiny_sampler(name, churn, decisions, factors), ("latent",),
                              must_launch, cpu=(refs, cpu_s))
        for dtype, f in fields.items():
            extra = {}
            if name == "DPM adaptive":
                # in fp32 the card must decide as the CPU does; in bf16 the two
                # UNets round differently, and where they part it is at the
                # loop's end, not at an accept / reject decision (ROADMAP queue
                # 3; scripts/dpm_adaptive_bf16.py): printed, the latents held
                # to the bf16 bar above
                cpu, card = (decisions[(d, _dtype_name(dtype))] for d in ("cpu", "cuda"))
                if dtype == torch.float32:
                    require(card == cpu, f"DPM adaptive {dtype}: accept / reject decisions on "
                                         f"the card {card} differ from the CPU's {cpu}")
                else:
                    extra.update(first_difference=_first_difference(decisions, factors))
                extra.update(decisions=card, cpu_decisions=cpu, decisions_match=card == cpu)
            emit("reference", dtype=_dtype_name(dtype), pipeline="tiny sampler", sampler=name,
                 churn=churn, flags={}, **f, **extra)


def _first_difference(decisions, factors, safety=0.81, h_init=0.05, steps=3):
    """DPM adaptive in bf16, card against CPU: None if both take the same
    decisions. Else the first iteration where they differ: a decision
    (accept / reject), or the loop's end (the same decisions, then one
    device takes one more iteration). With it each device's factor there,
    the ``safety`` it is held against, and each device's position s after
    every decision, replayed on the host from ``h_init`` and the factors as
    the controller steps (t = min(t_end, s + h), s = t on accept, h *=
    factor), against the loop's stop t_end - 1e-5. And bf16's rounding of
    the factor: at the first decision every run sees the same x, s and h,
    so the gap between the CPU's bf16 and fp32 factors there is what bf16
    does to the error estimate, and the card's gap to the CPU there is held
    against twice it (``within_bf16_rounding``, the form of the bf16 bar)."""
    import numpy as np

    from mdu_tpu_torch.samplers.schedule import NoiseSchedule

    card, cpu = decisions[("cuda", "bfloat16")], decisions[("cpu", "bfloat16")]
    f_card, f_cpu = factors[("cuda", "bfloat16")], factors[("cpu", "bfloat16")]
    f32 = factors[("cpu", "float32")]
    n = min(len(card), len(cpu))
    k = next((i for i in range(n) if card[i] != cpu[i]), None if len(card) == len(cpu) else n)
    if k is None:
        return None
    sig = NoiseSchedule().sampling_sigmas(steps)
    t_end = float(-np.log(sig[-2]))

    def positions(dec, fac):
        s, h, out = float(-np.log(sig[0])), h_init, []
        for accept, f in zip(dec, fac):
            t = min(t_end, s + h)
            s = t if accept else s
            h *= f
            out.append(s)
        return out

    p_card, p_cpu = positions(card, f_card), positions(cpu, f_cpu)
    gap0, rounding0 = abs(f_card[0] - f_cpu[0]), abs(f_cpu[0] - f32[0])
    return {"index": k, "kind": "decision" if k < n else "loop end",
            "card_factor": f_card[k] if k < len(f_card) else None,
            "cpu_factor": f_cpu[k] if k < len(f_cpu) else None, "threshold": safety,
            "card_decisions": len(card), "cpu_decisions": len(cpu),
            "t_end": t_end, "stop": t_end - 1e-5,
            "card_s_before": p_card[k - 1] if k else None,
            "cpu_s_before": p_cpu[k - 1] if k else None,
            "max_rel_factor_gap_shared": max(abs(a - b) / b for a, b in
                                             zip(f_card[:k], f_cpu[:k])) if k else None,
            "first_factor": {"card": f_card[0], "cpu": f_cpu[0], "cpu_fp32": f32[0]},
            "first_factor_gap": gap0, "bf16_rounding_of_first_factor": rounding0,
            "within_bf16_rounding": gap0 <= 2.0 * rounding0,
            "card_factors": f_card[:k + 1], "cpu_factors": f_cpu[:k + 1],
            "card_s": p_card[:k + 1], "cpu_s": p_cpu[:k + 1]}


def build_config2(dtype=None):
    """Config 2's pipeline, conds and settings: SD1.5 UNet and VAE with random
    weights drawn on the card, bf16 unless ``dtype`` says otherwise. Returns
    (pipe, cond, uncond, sampler, tiled_diffusion, tiled_vae)."""
    import torch

    from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig,
                               TiledDiffusionConfig, TiledVAEConfig)
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, VAEConfig,
                                      random_state_dict, sd15_unet_config)

    dev, bf16 = torch.device("cuda"), dtype or torch.bfloat16
    with torch.device("meta"):
        unet = UNet2DCondition(sd15_unet_config(), dtype=bf16)
        vae = AutoencoderKL(VAEConfig(), dtype=bf16)
    unet.load_state_dict(random_state_dict(unet, 0, bf16, dev), strict=True, assign=True)
    vae.load_state_dict(random_state_dict(vae, 1, bf16, dev), strict=True, assign=True)
    pipe = DiffusionPipeline(unet, vae)              # the card, by default
    require(pipe.device.type == "cuda", "pipeline did not resolve to the card")
    gen = torch.Generator(device=dev).manual_seed(2)
    cond = {"crossattn": (torch.randn(1, 77, 768, generator=gen, device=dev) * 0.1).to(bf16)}
    uncond = {"crossattn": (torch.randn(1, 77, 768, generator=gen, device=dev) * 0.1).to(bf16)}
    sp = SamplerConfig(name="Euler", steps=CFG2["steps"], cfg_scale=CFG2["cfg"])
    td = TiledDiffusionConfig(method=Method.MULTI_DIFF, tile_w=CFG2["tile"],
                              tile_h=CFG2["tile"], overlap=CFG2["overlap"],
                              tile_bs=CFG2["tile_bs"])
    tv = TiledVAEConfig(decoder_tile_size=CFG2["decoder_tile"], fast_decoder=False)
    return pipe, cond, uncond, sp, td, tv


def run_config2(pipe, cond, uncond, sp, td, tv, expected, label, n=2, keep=None):
    """1 warm image and ``n`` timed ones (``n`` = 0: the warm one alone);
    launches per image must equal ``expected`` (0 for every kernel it does
    not name). Returns the launches of the warm image and the ``txt2img``
    line's fields; ``keep``, a list, gets the warm image's result."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    def image(seed):
        res = pipe.txt2img(cond, uncond, width=CFG2["width"], height=CFG2["height"],
                           sampler=sp, seed=seed, tiled_diffusion=td, tiled_vae=tv)
        torch.cuda.synchronize()
        return res

    reset_launches()
    t0 = time.perf_counter()
    res = image(0)
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: expected.get(k, 0) for k in launches}
    require(launches == want, f"{label}: launches per image {launches}, expected {want}")
    require(tuple(res.images.shape) == (1, 512, 2048, 3),
            f"{label}: output shape {tuple(res.images.shape)}")
    require(bool(torch.isfinite(res.latents).all()), f"{label}: non-finite latents")
    if keep is not None:
        keep.append(res)
    if n == 0:
        return launches, dict(first_image_s=first_s, launches_per_image=launches,
                              output_shape=list(res.images.shape), finite=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for seed in range(1, n + 1):
        res = image(seed)
    timed_s = time.perf_counter() - t0
    per_image = {k: v / n for k, v in LAUNCHES.items()}
    require(per_image == launches, f"{label}: launches per image differ: "
                                   f"{per_image} vs {launches}")
    require(bool(torch.isfinite(res.latents).all()), f"{label}: non-finite latents")
    return launches, dict(first_image_s=first_s, img_per_min=60.0 * n / timed_s,
                          seconds_per_image=timed_s / n,
                          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                          output_shape=list(res.images.shape), finite=True,
                          launches_per_image=launches)


def phase_txt2img():
    """Config 2 with no flag, with the four flags and with MDU_FLASH=fm; then
    config 2 built in fp32 under MDU_FUSED_CONV=1 (1 warm and 1 timed
    image): returns the launches per image of each run."""
    import torch

    out = {}
    runs = [(None, CONFIG2_RUNS, EARLIER_TIMED), (torch.float32, (F32_RUN,), 1)]
    for dtype, config_runs, n in runs:
        t0 = time.perf_counter()
        pipe, cond, uncond, sp, td, tv = build_config2(dtype)
        setup_s = time.perf_counter() - t0
        for label, flags, expected in config_runs:
            with flags_set(flags):
                launches, fields = run_config2(pipe, cond, uncond, sp, td, tv, expected, label,
                                               0 if ("txt2img", label) in WARM_ONLY else n)
            emit("txt2img", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 "
                                   + ("fp32" if dtype == torch.float32 else "bf16"),
                 run=label, flags=flags, sampler=sp.name, steps=sp.steps,
                 cfg_scale=sp.cfg_scale, tile=[td.tile_h, td.tile_w], overlap=td.overlap,
                 tile_bs=td.tile_bs, decoder_tile=tv.decoder_tile_size, setup_s=setup_s,
                 expected_launches=expected, **fields)
            out[label] = launches
        del pipe, cond, uncond
        torch.cuda.empty_cache()
    return out


def phase_samplers():
    """Config 2 in bf16 with no flag under each sampler of ``SAMPLER_RUNS``: 1
    warm and 1 timed image; #1's launches per image pinned (10 a UNet call),
    #2's at 1."""
    import dataclasses

    import torch

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv = build_config2()
    setup_s = time.perf_counter() - t0
    for name, fm in SAMPLER_RUNS:
        sp_n = dataclasses.replace(sp, name=name)
        expected = {"flash_attention_fm": fm, "flash_attention_fm.sm90": fm,
                    "flash_attention": 1, "flash_attention.wide": 1}
        _, fields = run_config2(pipe, cond, uncond, sp_n, td, tv, expected, name,
                                n=0 if ("samplers", name) in WARM_ONLY else 1)
        emit("samplers", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16",
             flags={}, sampler=name, steps=sp_n.steps, cfg_scale=sp_n.cfg_scale,
             unet_calls_per_image=fm // 10, setup_s=setup_s, expected_launches=expected,
             **fields)
    del pipe, cond, uncond
    torch.cuda.empty_cache()


def build_config3():
    """Config 3 on config 2's pipeline (SD1.5 UNet and VAE, random bf16
    weights): Mixture of Diffusers img2img of a 512 x 512 image, Lanczos x4 to
    2048 x 2048, tiles 96 at overlap 8 in batches of up to 8, noise inversion
    of 10 steps at renoise 1, Euler 20 steps at denoise 0.4 (9 steps) and CFG
    7, exact tiled encode (tile 1024) and decode (tile 64), as
    ``bench.py:345-377`` runs it. Returns (pipe, cond, uncond, sampler,
    tiled_diffusion, tiled_vae, image)."""
    import numpy as np

    from mdu_tpu_torch import Method, SamplerConfig, TiledDiffusionConfig, TiledVAEConfig

    pipe, cond, uncond, _, _, _ = build_config2()
    td = TiledDiffusionConfig(method=Method.MIX_DIFF, tile_w=CFG3["tile"], tile_h=CFG3["tile"],
                              overlap=CFG3["overlap"], tile_bs=CFG3["tile_bs"],
                              upscaler="Lanczos", scale_factor=CFG3["scale"],
                              noise_inverse=True, noise_inverse_steps=CFG3["inverse_steps"],
                              noise_inverse_renoise_strength=CFG3["renoise"])
    tv = TiledVAEConfig(encoder_tile_size=CFG3["encoder_tile"],
                        decoder_tile_size=CFG3["decoder_tile"], fast_decoder=False,
                        fast_encoder=False)
    sp = SamplerConfig(name="Euler", steps=CFG3["steps"], cfg_scale=CFG3["cfg"],
                       denoising_strength=CFG3["denoise"])
    img = (np.random.default_rng(1).random((CFG3["image"],) * 2 + (3,)) * 255).astype(np.uint8)
    return pipe, cond, uncond, sp, td, tv, img


# stage -> the pipeline method it times
STAGE_METHODS = {"upscale": "_prepare_image", "encode": "_encode",
                 "noise_inversion": "noise_inversion", "sampling": "_sample",
                 "decode": "_decode_tensor"}
IMG2IMG_STAGES = ("upscale", "encode", "noise_inversion", "renoise_mask", "decode")


@contextlib.contextmanager
def stage_timer(pipe, stages=IMG2IMG_STAGES):
    """Seconds spent in each of ``stages`` (of ``STAGE_METHODS``, and
    ``renoise_mask``: the renoise mask on the host), each ended by a
    synchronize, summed per stage while the block runs."""
    import torch

    from mdu_tpu_torch import pipeline as pipeline_mod

    spent = {k: 0.0 for k in stages}
    methods = {k: STAGE_METHODS[k] for k in stages if k in STAGE_METHODS}

    def timed(stage, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t0
            return out
        return run

    for stage, attr in methods.items():
        setattr(pipe, attr, timed(stage, getattr(pipe, attr)))
    mask_fn = pipeline_mod.get_retouch_mask
    if "renoise_mask" in stages:
        pipeline_mod.get_retouch_mask = timed("renoise_mask", mask_fn)
    try:
        yield spent
    finally:
        for attr in methods.values():
            delattr(pipe, attr)
        pipeline_mod.get_retouch_mask = mask_fn


def phase_img2img():
    """Config 3 in bf16 with no flag and with the four flags: 1 warm and 1
    timed image, ``free_cache()`` before each (the full inversion every
    time). Launches per image must equal the pinned counts; the output must
    be (1, 2048, 2048, 3), the latents finite, and the decode's NaN chain
    not taken. Returns the launches per image of each run."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv, img = build_config3()
    setup_s = time.perf_counter() - t0
    side = int(CFG3["image"] * CFG3["scale"])
    out = {}
    for label, flags, expected in CONFIG3_RUNS:
        def image(seed):
            pipe.free_cache()
            res = pipe.img2img(img, cond, uncond, sampler=sp, seed=seed, tiled_diffusion=td,
                               tiled_vae=tv)
            torch.cuda.synchronize()
            require(tuple(res.images.shape) == (1, side, side, 3),
                    f"config 3 {label}: output shape {tuple(res.images.shape)}")
            require(bool(torch.isfinite(res.latents).all()),
                    f"config 3 {label}: non-finite latents")
            require(pipe.last_decode == "decode",
                    f"config 3 {label}: the decode's NaN chain gave the image "
                    f"({pipe.last_decode})")
            return res

        with flags_set(flags):
            reset_launches()
            t0 = time.perf_counter()
            image(0)
            first_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            want = {k: expected.get(k, 0) for k in launches}
            require(launches == want, f"config 3 {label}: launches per image {launches}, "
                                      f"expected {want}")
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            n = EARLIER_TIMED
            with stage_timer(pipe) as stages:
                t0 = time.perf_counter()
                for seed in range(1, n + 1):
                    image(seed)
                timed_s = time.perf_counter() - t0
            per_image = {k: v / n for k, v in LAUNCHES.items()}
            require(per_image == launches, f"config 3 {label}: launches per image differ: "
                                           f"{per_image} vs {launches}")
        emit("img2img", config="config 3: MoD img2img x4 512 -> 2048 with noise inversion, "
                               "SD1.5 bf16", run=label, flags=flags, sampler=sp.name,
             steps=sp.steps, denoising_strength=sp.denoising_strength,
             cfg_scale=sp.cfg_scale, tile=[td.tile_h, td.tile_w], overlap=td.overlap,
             tile_bs=td.tile_bs, inverse_steps=td.noise_inverse_steps,
             encoder_tile=tv.encoder_tile_size, decoder_tile=tv.decoder_tile_size,
             setup_s=setup_s, first_image_s=first_s, img_per_min=60.0 * n / timed_s,
             seconds_per_image=timed_s / n,
             stage_seconds_per_image={k: v / n for k, v in stages.items()},
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             output_shape=[1, side, side, 3], finite=True, nan_chain_taken=False,
             launches_per_image=launches, expected_launches=expected)
        out[label] = launches
    del pipe, cond, uncond
    torch.cuda.empty_cache()
    return out


def build_config4():
    """Config 4 on config 2's pipeline (SD1.5 UNet and VAE, random bf16
    weights) as ``bench.py:545-577`` runs it: MultiDiffusion txt2img at 1536
    x 1536, tiles 96 at overlap 48 in batches of up to 8, the background
    drawn, four BACKGROUND regions of 0.5 x 0.5 at the quadrants (seed -1),
    each with its own cond and the uncond, Euler 20 steps at CFG 7, exact
    tiled decode (tile 96). Returns (pipe, cond, uncond, sampler,
    tiled_diffusion, tiled_vae, region_conds)."""
    import torch

    from mdu_tpu_torch import Method, SamplerConfig, TiledDiffusionConfig, TiledVAEConfig
    from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec

    pipe, cond, uncond, _, _, _ = build_config2()
    regions = [RegionSpec(x, y, 0.5, 0.5, blend_mode=BlendMode.BACKGROUND)
               for x, y in CFG4["quadrants"]]
    td = TiledDiffusionConfig(method=Method.MULTI_DIFF, tile_w=CFG4["tile"], tile_h=CFG4["tile"],
                              overlap=CFG4["overlap"], tile_bs=CFG4["tile_bs"], regions=regions,
                              draw_background=True)
    tv = TiledVAEConfig(decoder_tile_size=CFG4["decoder_tile"], fast_decoder=False,
                        fast_encoder=False)
    sp = SamplerConfig(name="Euler", steps=CFG4["steps"], cfg_scale=CFG4["cfg"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    rc = [({"crossattn": (torch.randn(1, 77, 768, generator=gen, device="cuda") * 0.1
                          ).to(cond["crossattn"].dtype)}, uncond) for _ in regions]
    return pipe, cond, uncond, sp, td, tv, rc


def phase_regional():
    """Config 4 in bf16 with no flag and with the four flags: 1 warm and 1
    timed image, ``free_cache()`` before each. Launches per image must equal
    the pinned counts; the output must be (1, 1536, 1536, 3), the latents
    finite, and the decode's NaN chain not taken. Returns the launches per
    image of each run."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv, rc = build_config4()
    setup_s = time.perf_counter() - t0
    shape = (1, CFG4["height"], CFG4["width"], 3)
    out = {}
    for label, flags, expected in CONFIG4_RUNS:
        def image(seed):
            pipe.free_cache()
            res = pipe.txt2img(cond, uncond, width=CFG4["width"], height=CFG4["height"],
                               sampler=sp, seed=seed, tiled_diffusion=td, tiled_vae=tv,
                               region_conds=rc)
            torch.cuda.synchronize()
            require(tuple(res.images.shape) == shape,
                    f"config 4 {label}: output shape {tuple(res.images.shape)}")
            require(bool(torch.isfinite(res.latents).all()),
                    f"config 4 {label}: non-finite latents")
            require(pipe.last_decode == "decode",
                    f"config 4 {label}: the decode's NaN chain gave the image "
                    f"({pipe.last_decode})")
            return res

        with flags_set(flags):
            reset_launches()
            t0 = time.perf_counter()
            res = image(0)
            first_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            want = {k: expected.get(k, 0) for k in launches}
            require(launches == want, f"config 4 {label}: launches per image {launches}, "
                                      f"expected {want}")
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            n = EARLIER_TIMED
            with stage_timer(pipe, ("sampling", "decode")) as stages:
                t0 = time.perf_counter()
                for seed in range(1, n + 1):
                    image(seed)
                timed_s = time.perf_counter() - t0
            per_image = {k: v / n for k, v in LAUNCHES.items()}
            require(per_image == launches, f"config 4 {label}: launches per image differ: "
                                           f"{per_image} vs {launches}")
        emit("regional", config="config 4: 4 BACKGROUND regions, MultiDiffusion txt2img "
                                "1536x1536, SD1.5 bf16", run=label, flags=flags,
             sampler=sp.name, steps=sp.steps, cfg_scale=sp.cfg_scale,
             tile=[td.tile_h, td.tile_w], overlap=td.overlap, tile_bs=td.tile_bs,
             regions=[[r.x, r.y, r.w, r.h, r.blend_mode.value] for r in td.regions],
             region_seeds=[v["seed"] for v in
                           res.info["Tiled Diffusion"]["Region control"].values()],
             decoder_tile=tv.decoder_tile_size, unet_calls_per_image=sp.steps * 6,
             setup_s=setup_s, first_image_s=first_s, img_per_min=60.0 * n / timed_s,
             seconds_per_image=timed_s / n,
             stage_seconds_per_image={k: v / n for k, v in stages.items()},
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             output_shape=list(shape), finite=True, nan_chain_taken=False,
             launches_per_image=launches, expected_launches=expected)
        out[label] = launches
    del pipe, cond, uncond, rc
    torch.cuda.empty_cache()
    return out


def phase_upscale8k():
    """One 2048 x 2048 -> 8192 x 8192 upscale with no flag: config 3's
    settings with the 8K's fast tiled VAE (encoder tile 512, decoder tile 64,
    ``tile_batch`` 8), ``decode=False`` and then ``_decode_tensor``, as
    ``bench.py:508-513`` does. Its launches must equal the pinned counts, and
    the output must be [1, 3, 8192, 8192] and finite; its plan must decide
    the scan (18 tile batches, the JAX rule's threshold 8), which runs
    unrolled. Returns its launches."""
    import numpy as np
    import torch

    from mdu_tpu_torch import TiledVAEConfig
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    pipe, cond, uncond, sp, td, _, _ = build_config3()
    tv = TiledVAEConfig(encoder_tile_size=CFG8K["encoder_tile"],
                        decoder_tile_size=CFG8K["decoder_tile"], fast_decoder=True,
                        fast_encoder=True, tile_batch=CFG8K["tile_batch"])
    src = (np.random.default_rng(1).random((CFG8K["image"],) * 2 + (3,)) * 255
           ).astype(np.uint8)
    side = int(CFG8K["image"] * CFG3["scale"])
    plan = pipe._plan(td, side // 8, side // 8)
    require(plan.scan_tiles and plan.num_batches == 18,
            f"8K upscale: scan_tiles {plan.scan_tiles}, {plan.num_batches} tile batches")
    pipe.free_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with stage_timer(pipe) as stages:
        t0 = time.perf_counter()
        res = pipe.img2img(src, cond, uncond, sampler=sp, seed=0, tiled_diffusion=td,
                           tiled_vae=tv, decode=False)
        out = pipe._decode_tensor(res.latents, tv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: EXPECTED_8K.get(k, 0) for k in launches}
    require(launches == want, f"8K upscale: launches {launches}, expected {want}")
    require(tuple(out.shape) == (1, 3, side, side), f"8K upscale: output {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "8K upscale: non-finite output")
    emit("upscale8k", config="2K -> 8K: MoD img2img x4 2048 -> 8192 with noise inversion, "
                             "fast tiled VAE, SD1.5 bf16", flags={}, seconds=seconds,
         img_per_min=60.0 / seconds, stage_seconds=dict(stages),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         output_shape=list(out.shape), finite=True, scan_tiles=plan.scan_tiles,
         tile_batches=plan.num_batches, launches=launches, expected_launches=EXPECTED_8K)
    del pipe, cond, uncond, res, out
    torch.cuda.empty_cache()
    return launches


def build_config5():
    """Config 5 as ``bench.py:579-640`` builds it: the SDXL UNet, the SD VAE
    (built, not run) and a ControlNet of the UNet's config, random bf16
    weights drawn on the card (the ControlNet's gates zero, as the JAX
    package's ``random_params`` makes them); crossattn randn [1, 77, 2048] x
    0.1, vector zeros [1, 1280], control [zeros [1, 3, 1024, 1024]], the
    uncond's crossattn zeros; DemoFusion x3 (windows 128 at overlap 64,
    batches of 2), Euler 20 steps at CFG 7 and denoise 0.45. Returns (pipe,
    cond, uncond, demofusion config, sampler)."""
    import torch

    from mdu_tpu_torch import DemoFusionConfig, DiffusionPipeline, SamplerConfig
    from mdu_tpu_torch.models import (AutoencoderKL, ControlNet, UNet2DCondition, VAEConfig,
                                      random_state_dict, sdxl_unet_config)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    ucfg = sdxl_unet_config()
    with torch.device("meta"):
        unet = UNet2DCondition(ucfg, dtype=bf16)
        vae = AutoencoderKL(VAEConfig(), dtype=bf16)
        cn = ControlNet(ucfg, dtype=bf16)
    for i, mod in enumerate((unet, vae, cn)):
        mod.load_state_dict(random_state_dict(mod, i, bf16, dev), strict=True, assign=True)
    pipe = DiffusionPipeline(unet, vae, controlnet=cn)
    require(pipe.device.type == "cuda", "pipeline did not resolve to the card")
    gen = torch.Generator(device=dev).manual_seed(2)
    size = CFG5["size"]
    cond = {"crossattn": (torch.randn(1, 77, 2048, generator=gen, device=dev) * 0.1).to(bf16),
            "vector": torch.zeros(1, ucfg.addition_pooled_dim, dtype=bf16, device=dev),
            "control": [torch.zeros(1, 3, size, size, dtype=bf16, device=dev)]}
    uncond = dict(cond, crossattn=torch.zeros(1, 77, 2048, dtype=bf16, device=dev))
    cfg = DemoFusionConfig(window_size=CFG5["window"], overlap=CFG5["overlap"],
                           scale_factor=CFG5["scale"], tile_bs=CFG5["tile_bs"],
                           tile_bs_g=CFG5["tile_bs"], scan_windows=True)
    sp = SamplerConfig(name="Euler", steps=CFG5["steps"], cfg_scale=CFG5["cfg"],
                       denoising_strength=CFG5["denoise"])
    return pipe, cond, uncond, cfg, sp


def phase_demofusion():
    """Config 5 through ``DiffusionPipeline.demofusion``: a warm x2 image
    (every shape of the x3 one) with its launches pinned; one timed x3
    image with no flag (seconds per phase, img/min, peak memory; the final
    latent [1, 4, 384, 384] and finite, three phase latents; launches
    pinned); one x2 image under the four flags (launches pinned, seconds).
    Returns the launches of the x3 image and of the flagged one."""
    import dataclasses

    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    pipe, cond, uncond, cfg, sp = build_config5()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_bytes = sum(p.numel() * p.element_size()
                        for m in (pipe.unet, pipe.controlnet) for p in m.parameters())
    phase_s = []
    sample = pipe._sample

    def timed_sample(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sample(*a, **kw)
        torch.cuda.synchronize()
        phase_s.append(time.perf_counter() - t)
        return out

    pipe._sample = timed_sample
    size, latent = CFG5["size"], CFG5["size"] // 8
    out = {}
    # the last run: DeepCache N = 2 on the global views (and the base phase)
    sp_x2 = dataclasses.replace(sp, steps=CFG5["steps_x2"])
    sp_dc = dataclasses.replace(sp_x2, deepcache=2)
    runs = (("warm x2", {}, 2, EXPECTED_CONFIG5_X2, sp_x2),
            ("default", {}, 3, EXPECTED_CONFIG5, sp),
            ("flagged x2", FLAGS, 2, EXPECTED_CONFIG5_FLAGGED, sp_x2),
            ("deepcache x2", {}, 2, EXPECTED_CONFIG5_DC, sp_dc))
    results = {}
    for label, flags, scale, expected, sp_run in runs:
        phase_s.clear()
        with flags_set(flags):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            res = pipe.demofusion(cond, uncond, size, size,
                                  dataclasses.replace(cfg, scale_factor=scale), sp_run, seed=0,
                                  decode=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want = {k: expected.get(k, 0) for k in launches}
        require(launches == want, f"config 5 {label}: launches {launches}, expected {want}")
        side = latent * scale
        require(tuple(res.latents.shape) == (1, 4, side, side),
                f"config 5 {label}: final latent {tuple(res.latents.shape)}")
        require(len(res.phase_latents) == scale, f"config 5 {label}: "
                                                 f"{len(res.phase_latents)} phase latents")
        require(all(bool(torch.isfinite(p).all()) for p in res.phase_latents),
                f"config 5 {label}: non-finite latents")
        require(res.info["DemoFusion"]["Phase sizes"]
                == [[size * k, size * k] for k in range(1, scale + 1)],
                f"config 5 {label}: phase sizes {res.info['DemoFusion']['Phase sizes']}")
        results[label] = res.latents
        extra = {}
        if sp_run.deepcache > 1:
            extra["mean_abs_latent_diff_from_exact"] = float(
                (res.latents.float() - results["warm x2"].float()).abs().mean())
        emit("demofusion", config="config 5: SDXL DemoFusion with ControlNet, 1024 -> "
                                  f"{size * scale}, bf16", run=label, flags=flags, scale=scale,
             sampler=sp.name, steps=sp_run.steps, cfg_scale=sp.cfg_scale,
             deepcache=sp_run.deepcache, **extra,
             denoising_strength=sp.denoising_strength, window=cfg.window_size,
             overlap=cfg.overlap, tile_bs=cfg.tile_bs, tile_bs_g=cfg.tile_bs_g,
             guided_calls=C5_CALLS[scale], setup_s=setup_s, seconds=seconds,
             img_per_min=60.0 / seconds, phase_seconds=list(phase_s),
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             unet_controlnet_weight_bytes=weights_bytes,
             final_latent_shape=list(res.latents.shape),
             phase_latent_shapes=[list(p.shape) for p in res.phase_latents],
             latent_std=[float(p.float().std()) for p in res.phase_latents], finite=True,
             launches=launches, expected_launches=expected)
        out[label] = launches
    del pipe, cond, uncond, res, results
    torch.cuda.empty_cache()
    return {"default": out["default"], "flagged": out["flagged x2"],
            "deepcache x2": out["deepcache x2"]}


# ------------------------------------------------ DeepCache, the adapters, unCLIP


def phase_deepcache():
    """Config 2 (bf16) under DeepCache N = 2, branch 1 (``DEEPCACHE``), built
    as phase ``txt2img`` builds it, with no flag and with the four flags: 1
    warm and 2 timed images with their launches pinned, then the mean
    absolute pixel difference of the warm (seed-0) image from the exact
    image of that seed. Returns the launches per image of each run."""
    import dataclasses

    import numpy as np
    import torch

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv = build_config2()
    setup_s = time.perf_counter() - t0
    sp_dc = dataclasses.replace(sp, deepcache=DEEPCACHE["interval"],
                                deepcache_branch=DEEPCACHE["branch"])
    out = {}
    for label, flags, expected in DEEPCACHE_RUNS:
        kept = []
        with flags_set(flags):
            launches, fields = run_config2(pipe, cond, uncond, sp_dc, td, tv, expected,
                                           f"deepcache {label}", keep=kept)
            exact = pipe.txt2img(cond, uncond, width=CFG2["width"], height=CFG2["height"],
                                 sampler=sp, seed=0, tiled_diffusion=td, tiled_vae=tv)
            images = [np.asarray(exact.images), np.asarray(kept.pop().images)]
        diff = float(np.abs(images[0].astype(np.int16) - images[1].astype(np.int16)).mean())
        emit("deepcache", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16, "
                                 "DeepCache", run=label, flags=flags, sampler=sp.name,
             steps=sp.steps, cfg_scale=sp.cfg_scale, deepcache=sp_dc.deepcache,
             deepcache_branch=sp_dc.deepcache_branch, setup_s=setup_s,
             mean_abs_pixel_diff_from_exact=diff, expected_launches=expected, **fields)
        out[label] = launches
    del pipe, cond, uncond
    torch.cuda.empty_cache()
    return out


def phase_mesh():
    """Config 2 (bf16, exactly as ``txt2img`` builds it) under
    ``deterministic`` on a tile mesh: on one device without a mesh (the
    reference image), on a 1-shard mesh, on a 2-shard mesh on cuda:0 (and
    once under MDU_FUSED_BLEND=1, #5 0) and on the 2-shard mesh under
    DeepCache N = 2 against one device's DeepCache image; launches pinned,
    img/min and peak memory of the three mesh runs, whether each mesh
    image's latents equal the reference's to the bit (the expectation: every
    UNet call has one device's shape) and else that they are within 1e-3 x
    max of them (the reference phase's bar, 2 e + 1e-3 x max, without its
    e), and the pixel difference of its sharded exact decode. Then the sharded exact
    decode of the reference latents against the lockstep decode, in fp32
    within 1 uint8 level and in bf16 within 2 e + 1e-3 x max (e: the bf16
    lockstep's error against the fp32 lockstep). Returns each run's launches
    per image."""
    import numpy as np
    import torch

    from mdu_tpu_torch.parallel import make_tile_mesh

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv = build_config2()
    td = dataclasses.replace(td, deterministic=True)
    sp_dc = dataclasses.replace(sp, deepcache=DEEPCACHE["interval"],
                                deepcache_branch=DEEPCACHE["branch"])
    setup_s = time.perf_counter() - t0
    config = "config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16, deterministic"
    refs = []
    for sampler, expected, label in ((sp, EXPECTED_LAUNCHES, "one device"),
                                     (sp_dc, EXPECTED_DEEPCACHE, "one device, DeepCache")):
        run_config2(pipe, cond, uncond, sampler, td, tv, expected, f"mesh: {label}", n=0,
                    keep=refs)
    ref, ref_dc = refs
    runs = [(n, "", sp, {}, EXPECTED_MESH[n], ref, 1) for n in MESH_SHARDS]
    runs += [(2, " MDU_FUSED_BLEND", sp, {"MDU_FUSED_BLEND": "1"}, EXPECTED_MESH[2], ref, 0),
             (2, " DeepCache", sp_dc, {}, EXPECTED_MESH_DEEPCACHE, ref_dc, 1)]
    out = {}
    for n, what, sampler, flags, expected, want, timed in runs:
        label = f"{n} shard{'s' if n > 1 else ''}{what}"
        pipe.mesh = make_tile_mesh(devices=["cuda:0"] * n)
        kept = []
        try:
            with flags_set(flags):
                _, fields = run_config2(pipe, cond, uncond, sampler, td, tv, expected,
                                        f"mesh {label}", n=timed, keep=kept)
        finally:
            pipe.mesh = None
        res = kept.pop()
        diff = (res.latents.float() - want.latents.float()).abs().max().item()
        scale = want.latents.float().abs().max().item()
        require(diff <= 1e-3 * scale, f"mesh {label}: latents {diff} from one device's")
        pixels = np.abs(np.asarray(res.images).astype(np.int16)
                        - np.asarray(want.images).astype(np.int16))
        emit("mesh", config=config, run=label, shards=n, devices=["cuda:0"] * n, flags=flags,
             sampler=sampler.name, steps=sampler.steps, deepcache=sampler.deepcache,
             setup_s=setup_s, latents_bitwise_equal=diff == 0.0, latents_max_abs_diff=diff,
             latents_bar=1e-3 * scale, image_max_abs_diff=int(pixels.max()),
             image_mean_abs_diff=float(pixels.mean()), expected_launches=expected, **fields)
        out[label] = fields["launches_per_image"]

    # the sharded exact decode against the lockstep of the same latents: in
    # fp32 (a float copy of the VAE) within 1 uint8 level, the JAX tests'
    # bar; in bf16 within 2 e + 1e-3 x max, e the bf16 lockstep's largest
    # difference from the fp32 lockstep (a bf16 rounding that the pooled
    # sums' other order flips moves through the decoder)
    from mdu_tpu_torch.models import AutoencoderKL, VAEConfig
    from mdu_tpu_torch.utils.image import tensor_to_image

    vae16 = pipe.vae
    with torch.device("meta"):
        vae32 = AutoencoderKL(VAEConfig(), dtype=torch.float32)
    vae32.load_state_dict({k: v.float() for k, v in vae16.state_dict().items()},
                          strict=True, assign=True)
    decoded = {}
    try:
        for name, vae in (("bf16", vae16), ("fp32", vae32)):
            pipe.vae = vae
            for shards in (0, 2):
                pipe.mesh = make_tile_mesh(devices=["cuda:0"] * shards) if shards else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                z = pipe._decode_tensor(ref.latents, tv).float()
                torch.cuda.synchronize()
                decoded[name, shards] = (z, time.perf_counter() - t0, pipe.last_vae_mode)
    finally:
        pipe.vae, pipe.mesh = vae16, None
    require([decoded[k][2] for k in sorted(decoded)] == ["lockstep", "sharded"] * 2,
            f"mesh decode: modes {[decoded[k][2] for k in sorted(decoded)]}")
    lock32 = decoded["fp32", 0][0]
    e = (decoded["bf16", 0][0] - lock32).abs().max().item()
    for name in ("fp32", "bf16"):
        lock, shard = decoded[name, 0][0], decoded[name, 2][0]
        diff = (shard - lock).abs().max().item()
        levels = int(np.abs(tensor_to_image(shard).astype(np.int16)
                            - tensor_to_image(lock).astype(np.int16)).max())
        bar = 2 * e + 1e-3 * lock32.abs().max().item()
        if name == "fp32":
            require(levels <= 1, f"mesh decode fp32: {levels} uint8 levels from the lockstep")
        else:
            require(diff <= bar, f"mesh decode bf16: {diff} from the lockstep, bar {bar}")
        emit("mesh", run=f"sharded exact decode {name}, 2 shards on cuda:0",
             decoder_tile=tv.decoder_tile_size, lockstep_s=decoded[name, 0][1],
             sharded_s=decoded[name, 2][1], max_abs_diff=diff, uint8_levels=levels,
             bar=("1 uint8 level" if name == "fp32" else bar), bf16_lockstep_error=e)
    out.update(run_mesh_demofusion(pipe, cond, uncond))
    del pipe, cond, uncond
    torch.cuda.empty_cache()
    return out


def run_mesh_demofusion(pipe, cond, uncond):
    """DemoFusion x2 of config 2's SD1.5 (bf16) from 512^2 (``DF_MESH``: 4
    windows of 96 latent in 2 calls, 4 views in 2, Euler) on one device and
    on two shards of cuda:0: each shard takes one window call and one view
    call, of one device's shapes, so the latents should be one device's to
    the bit; else within 1e-3 x max (the mesh's bar), and the line says so.
    #1 10 a UNet call at 64^2 (base, views), 15 at 96^2 (windows); no
    decode."""
    import torch

    from mdu_tpu_torch import DemoFusionConfig, SamplerConfig
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.parallel import make_tile_mesh

    cfg = DemoFusionConfig(scale_factor=2, window_size=DF_MESH["window"],
                           overlap=DF_MESH["overlap"], tile_bs=2, tile_bs_g=2)
    sp = SamplerConfig(name="Euler", steps=DF_MESH["steps"], cfg_scale=7.0,
                       denoising_strength=DF_MESH["denoise"])
    # phase 2 samples the last t_enc + 1 sigmas' t_enc + 1 steps (Euler: one
    # call a step), 2 window calls and 2 view calls each; the base's and the
    # views' calls at 64^2 (levels 0 and 1 at >= 512 tokens: 10 #1 a call),
    # the windows' at 96^2 (levels 0-2: 15)
    n2 = pipe.schedule.img2img_steps(sp.steps, DF_MESH["denoise"])[1] + 1
    calls = sp.steps + n2 * 4
    flash = 10 * (sp.steps + n2 * 2) + 15 * n2 * 2
    expected = {"flash_attention_fm": flash, "flash_attention_fm.sm90": flash}
    res, out = {}, {}
    for shards in (0, 2):
        label = f"DemoFusion x2, {'2 shards on cuda:0' if shards else 'one device'}"
        pipe.mesh = make_tile_mesh(devices=["cuda:0"] * shards) if shards else None
        try:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[shards] = pipe.demofusion(cond, uncond, DF_MESH["size"], DF_MESH["size"], cfg,
                                          sp, seed=3, decode=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            pipe.mesh = None
        launches = {k: v for k, v in LAUNCHES.items() if v}
        require(launches == expected, f"mesh {label}: launches {launches}, expected {expected}")
        lat = res[shards].latents
        require(tuple(lat.shape) == (1, 4, DF_MESH["size"] // 4, DF_MESH["size"] // 4)
                and bool(torch.isfinite(lat).all()), f"mesh {label}: latents {tuple(lat.shape)}")
        fields = dict(seconds=seconds, launches_per_image=launches)
        if shards:
            want = res[0].latents.float()
            diff = (lat.float() - want).abs().max().item()
            bar = 1e-3 * want.abs().max().item()
            require(diff <= bar, f"mesh {label}: latents {diff} from one device's, bar {bar}")
            fields.update(latents_bitwise_equal=diff == 0.0, latents_max_abs_diff=diff,
                          latents_bar=bar)
        emit("mesh", run=label, config="SD1.5 bf16 (config 2's), DemoFusion x2 from "
             f"{DF_MESH['size']}^2", shards=shards or 1, unet_calls=calls, **DF_MESH,
             expected_launches=expected, **fields)
        out[label] = launches
    return out


def check_attention_bwd(gen, summary):
    """The backward at ``BWD_SHAPES`` in fp32 and bf16, in the form the rule
    picks (``bwd_form``: the tensor-core forms f32_sm90 and bf16_sm90 take
    every entry) and, at the first ``BWD_SIMT_SHAPES`` (the train step's
    levels), also in the CUDA-core form (f32_simt, bf16_simt: the earlier
    form, the ``earlier_*`` fields). Each held to autograd through #1's fp32 plain
    version on the same inputs: fp32 within 1e-4 of the largest gradient,
    bf16 within 2x the bf16 plain version's error + 1e-3 of it (each of dQ,
    dK, dV; the line gives the largest error over the three, relative to that
    gradient's largest entry). Times: the kernel (events and device), the
    plain version (``flash_attention_bwd_plain``), and the backward of
    ``F.scaled_dot_product_attention`` at the same shape as the yardstick
    (its forward run once, outside the timing). Bound: 12 B H Lq Lk D
    operations (2.5x the forward's products for dQ, dK, dV and the
    recomputed Q K^T) against q, k, v, O, dO read and dQ, dK, dV written;
    fp32 at three TF32 passes, with the CUDA cores' FMA bound beside it."""
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import flash
    from mdu_tpu_torch.ops.kernels.flash_bwd import (bwd_form, flash_attention_bwd,
                                                      flash_attention_bwd_plain, launch_bwd_form)

    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        simt = "bf16_simt" if dtype == torch.bfloat16 else "f32_simt"
        for n_shape, (B, H, Lq, Lk, D) in enumerate(BWD_SHAPES):
            base = [torch.randn(B, H, L, D, generator=gen, device="cuda")
                    for L in (Lq, Lk, Lk)]
            do = torch.randn(B, H, Lq, D, generator=gen, device="cuda")

            def autograd_of_plain(dt):
                ts = [x.to(dt).requires_grad_() for x in base]
                return torch.autograd.grad(flash.flash_attention_fm_plain(*ts), ts, do.to(dt))

            ref = autograd_of_plain(torch.float32)
            q, k, v = (x.to(dtype) for x in base)
            g = do.to(dtype)
            o = flash.flash_attention_fm(q, k, v)
            own = autograd_of_plain(dtype) if dtype == torch.bfloat16 else None
            form = bwd_form(q, k, v, g)
            big = B * H * Lq * Lk > 1e8
            iters = 5 if big else 20
            runs = {form: lambda: flash_attention_bwd(q, k, v, o, g)}
            if n_shape < BWD_SIMT_SHAPES and form != simt:
                runs[simt] = lambda: launch_bwd_form(simt, q, k, v, o, g)
            measured = {}
            for f, kern in runs.items():
                got = kern()
                torch.cuda.synchronize()
                errs, tols = [], []
                for i, (a, r) in enumerate(zip(got, ref)):
                    scale = r.abs().max().item()
                    require(bool(torch.isfinite(a).all()),
                            f"flash_attention_bwd {f}: non-finite d{i}")
                    errs.append((a.float() - r).abs().max().item() / scale)
                    tols.append(1e-4 if dtype == torch.float32 else
                                2 * (own[i].float() - r).abs().max().item() / scale + 1e-3)
                for i in range(3):
                    require(errs[i] <= tols[i], f"flash_attention_bwd {f} {(B, H, Lq, Lk, D)}: "
                                                f"gradient {i} error {errs[i]} > {tols[i]} x max")
                del got
                measured[f] = dict(errs=errs, tols=tols, ms=cuda_ms(kern, iters),
                                   device_ms=device_ms(kern, iters))
            del ref, own
            plain = lambda: flash_attention_bwd_plain(q, k, v, o, g)
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qs, ks, vs)
            lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), g, retain_graph=True)
            flops = 12.0 * B * H * Lq * Lk * D
            nbytes = 4.0 * (Lq + Lk) * B * H * D * q.element_size()
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
            bound_ms, bound_by = bound(flops, nbytes, q.element_size(), peak)
            main = measured[form]
            check = dict(shape=[B, H, Lq, Lk, D], dtype=_dtype_name(dtype), form=form,
                         max_abs_err=max(main["errs"]), errors=main["errs"],
                         tol=min(main["tols"]), ms=main["ms"], device_ms=main["device_ms"],
                         plain_ms=cuda_ms(plain, 2, warmup=1), library_ms=cuda_ms(lib, iters),
                         library_device_ms=device_ms(lib, iters), library_backend=
                         sdpa_backend(q, k, v), bound_ms=bound_ms, bound_by=bound_by,
                         error_basis="largest |got - autograd of the fp32 plain version| "
                                     "over dQ, dK, dV, each over that gradient's largest")
            if simt in measured and simt != form:
                check.update(earlier_form=simt, earlier_ms=measured[simt]["ms"],
                             earlier_device_ms=measured[simt]["device_ms"],
                             earlier_max_abs_err=max(measured[simt]["errs"]))
            if dtype == torch.float32:
                check["fma_bound_ms"] = bound(flops, nbytes, 4, PEAK_FP32_FLOPS)[0]
            emit("kernel_check", name="flash_attention_bwd", **check)
            checks.append(check)
            del q, k, v, o, g, base, do, qs, ks, vs, lib_out
            torch.cuda.empty_cache()
    summary["flash_attention_bwd"] = checks


def phase_train():
    """The dp x tp train step (``make_train_step``) at SD1.5's full width,
    random fp32 weights drawn on the card, TF32 off: 3 steps of batch 2 at dp
    = tp = 1 (finite losses; seconds a step, samples/s, peak memory), step 1
    again under remat, step 1 with the long attentions routed through #1's
    plain version (a patch of ``ops.attention._flash_variant`` here, never a
    switch of the package), and step 1 at dp = 2 x tp = 2 on cuda:0 x 4; the
    launches of each step pinned. Each variant against the kernel step 1:
    the loss within 1e-5 relative, the gradient (AdamW's exp_avg, 0.1 g)
    within 1e-3 of its largest entry against the plain route and 1e-4 under
    remat and on the mesh, and the parameters after the step where |g| is 10x
    that bar within 1e-3 x lr (elsewhere Adam's first step lr g / (|g| + eps)
    is rounding noise's sign, held to its bound lr (1 + wd |theta|)). The 30
    weights that carry the backward kernel's output (to_q, to_k, to_v of the
    10 self-attentions at levels 0 and 1) are held each to the same bar of
    its own largest entry, so that a fault the shared bar would hide in
    their small gradients still fails. Returns each run's launches per
    step."""
    import torch

    from mdu_tpu_torch.models import UNet2DCondition, random_state_dict, sd15_unet_config
    from mdu_tpu_torch.ops import attention as attention_mod
    from mdu_tpu_torch.ops.kernels import LAUNCHES, flash, reset_launches
    from mdu_tpu_torch.parallel import make_train_mesh, make_train_step

    smi = nvidia_smi_line()
    with torch.device("meta"):
        unet = UNet2DCondition(sd15_unet_config(), dtype=torch.float32)
    unet.load_state_dict(random_state_dict(unet, 0, torch.float32, device="cuda"),
                         assign=True)
    params0 = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, hw = TRAIN["batch"], TRAIN["latent"]
    lat = torch.randn(n, 4, hw, hw, generator=gen, device="cuda")
    ctx = torch.randn(n, TRAIN["tokens"], 768, generator=gen, device="cuda") * 0.1
    batch = {"latents": lat, "context": ctx}
    draws = [{"t": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
              "noise": torch.randn(lat.shape, generator=gen, device="cuda")}
             for _ in range(TRAIN["steps"])]

    def run(label, dp, tp, expected, steps=1, remat=False):
        mesh = make_train_mesh(dp, tp, devices=["cuda:0"] * (dp * tp))
        init_state, jitted = make_train_step(unet, mesh, learning_rate=TRAIN["lr"],
                                             remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, p_shard = init_state(params0)
        step = jitted(p_shard)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        losses, times = [], []
        for i in range(steps):
            reset_launches()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, batch, draws[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            launches = {k: v for k, v in LAUNCHES.items() if v}
            want = {k: v for k, v in expected.items() if v}
            require(launches == want, f"train {label} step {i + 1}: launches {launches}, "
                                      f"expected {want}")
            if i == 0:              # copies: the next steps update in place
                first = dict(loss=losses[0],
                             mu={k: opt.moment("exp_avg", k).clone() for k in params.names},
                             params={k: v.clone() for k, v in params.state_dict().items()})
        require(all(math.isfinite(x) for x in losses), f"train {label}: losses {losses}")
        fields = dict(run=label, dp=dp, tp=tp, remat=remat, batch=n,
                      latents=list(lat.shape), context=list(ctx.shape), losses=losses,
                      step_s=times, setup_s=setup_s,
                      samples_per_s=(n * (steps - 1) / sum(times[1:]) if steps > 1 else None),
                      seconds_per_step=(sum(times[1:]) / (steps - 1) if steps > 1 else times[0]),
                      max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                      launches_per_step=launches, nvidia_smi=smi)
        del params, opt, step
        torch.cuda.empty_cache()
        return first, fields

    kernel_leaves = [k for k in params0 if re.fullmatch(
        r"(down_[01]|up_[23])_attn_\d+\.block_\d+\.attn1\.to_[qkv]\.weight", k)]
    require(len(kernel_leaves) == 30, f"train: {len(kernel_leaves)} attention leaves at "
                                      f"levels 0 and 1, expected 30")

    def hold(label, got, ref, bar):
        dl = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        require(dl <= 1e-5, f"train {label}: loss {got['loss']} against {ref['loss']}")
        gmax = max(m.abs().max().item() for m in ref["mu"].values())
        g_err = max((got["mu"][k] - m).abs().max().item() for k, m in ref["mu"].items())
        require(g_err <= bar * gmax, f"train {label}: gradient {g_err} > {bar} x {gmax}")
        attn_rel = 0.0
        for k in kernel_leaves:
            lmax = ref["mu"][k].abs().max().item()
            err = (got["mu"][k] - ref["mu"][k]).abs().max().item()
            require(err <= bar * lmax, f"train {label}: {k} gradient {err} > {bar} x {lmax}")
            attn_rel = max(attn_rel, err / lmax)
        p_err, over = 0.0, 0
        for k, theta1 in ref["params"].items():
            step_got, step_ref = got["params"][k] - params0[k], theta1 - params0[k]
            firm = ref["mu"][k].abs() >= 10 * bar * gmax
            if firm.any():
                p_err = max(p_err, (step_got - step_ref)[firm].abs().max().item())
            lim = TRAIN["lr"] * (1 + 1e-4 * params0[k].abs()) + 2e-7 * params0[k].abs()
            over += int((step_got.abs() > lim).sum().item())
        require(p_err <= 1e-3 * TRAIN["lr"], f"train {label}: parameters {p_err} from the "
                                             f"kernel step's")
        require(over == 0, f"train {label}: {over} parameters moved past Adam's bound")
        return dict(loss_rel_diff=dl, gradient_max_abs_diff=g_err, gradient_max=gmax,
                    gradient_bar=bar * gmax, attention_leaf_max_rel_diff=attn_rel,
                    attention_leaf_bar=bar, firm_param_max_abs_diff=p_err)

    out = {}
    ref, fields = run("dp 1 x tp 1", 1, 1, EXPECTED_TRAIN, steps=TRAIN["steps"])
    emit("train", **fields)
    out["dp 1 x tp 1"] = fields["launches_per_step"]
    got, fields = run("remat", 1, 1, EXPECTED_TRAIN_REMAT, remat=True)
    emit("train", **fields, **hold("remat", got, ref, 1e-4))
    out["remat"] = fields["launches_per_step"]
    saved = attention_mod._flash_variant
    attention_mod._flash_variant = lambda D: flash.flash_attention_fm_plain
    try:
        got, fields = run("plain attention", 1, 1, {})
    finally:
        attention_mod._flash_variant = saved
    emit("train", **fields, **hold("plain attention", got, ref, 1e-3))
    got, fields = run("dp 2 x tp 2 on cuda:0 x 4", 2, 2, EXPECTED_TRAIN_DP2_TP2)
    emit("train", **fields, **hold("dp 2 x tp 2", got, ref, 1e-4))
    out["dp 2 x tp 2"] = fields["launches_per_step"]
    del unet, params0, ref, got
    torch.cuda.empty_cache()
    return out


def rrdb_flops(cfg, h: int, w: int) -> float:
    """The multiply-adds x 2 of an RRDBNet x4 on an h x w image: 3 dense
    blocks of 5 convs in each RRDB at h x w, conv_body at h x w, conv_up1 at
    2h x 2w, conv_up2, conv_hr and conv_last at 4h x 4w (3 x 3 kernels)."""
    nf, g = cfg.num_feat, cfg.grow
    rdb = sum((nf + k * g) * g for k in range(4)) + (nf + 4 * g) * nf
    px = h * w
    macs = 9 * (px * (3 * nf + 3 * cfg.num_blocks * rdb + nf * nf)
                + 4 * px * nf * nf + 16 * px * (2 * nf * nf + nf * 3))
    return 2.0 * macs


def phase_adapters():
    """Config 3 (bf16, no flag; ``build_config3``) three ways, 1 warm and 1
    timed image each, ``free_cache()`` before each: (a) with a full-width
    StableSR guidance encoder (``StableSRGuidance(sd15_unet_config())``,
    random bf16 weights, its zero convs drawn small so that the residuals are
    not zero), the guidance leaf the init image's latent on cond and uncond;
    (b) with a full-width ESRGAN x4 (64 features, 23 blocks, grow 32, random
    fp32 weights written as a new-arch .safetensors into a temporary
    directory of the checkout and loaded by ``load_esrgan``) as the
    pre-upscaler in place of Lanczos, held card against CPU on a 64 x 64
    crop in fp32 within 1e-4 of the largest value; (c) image CFG 1.5 on an
    SD1.5 UNet with 8 input channels. Each: img/min, seconds per stage, peak
    memory, launches pinned (those of config 3: no adapter has attention).
    Returns the launches per image of each."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from mdu_tpu_torch import DiffusionPipeline
    from mdu_tpu_torch.models import (RRDBNet, RRDBNetConfig, StableSRGuidance,
                                      UNet2DCondition, load_esrgan, random_state_dict,
                                      sd15_unet_config)
    from mdu_tpu_torch.models.esrgan import esrgan_upscaler, translate_esrgan_name
    from mdu_tpu_torch.models.safetensors import save_file
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.upscale import register_upscaler
    from mdu_tpu_torch.utils.image import image_to_tensor

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv, img = build_config3()
    setup_s = time.perf_counter() - t0
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    side = int(CFG3["image"] * CFG3["scale"])
    stages = ("upscale", "encode", "noise_inversion", "renoise_mask", "sampling", "decode")
    out = {}

    def run(label, p, c, u, s, t, **extra):
        for seed, timed in ((0, False), (1, True)):
            p.free_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with stage_timer(p, stages) as spent:
                t1 = time.perf_counter()
                res = p.img2img(img, c, u, sampler=s, seed=seed, tiled_diffusion=t,
                                tiled_vae=tv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t1
            launches = dict(LAUNCHES)
            want = {k: EXPECTED_CONFIG3.get(k, 0) for k in launches}
            require(launches == want, f"adapters {label}: launches {launches}, expected {want}")
            require(tuple(res.images.shape) == (1, side, side, 3),
                    f"adapters {label}: output shape {tuple(res.images.shape)}")
            require(bool(torch.isfinite(res.latents).all()),
                    f"adapters {label}: non-finite latents")
            require(p.last_decode == "decode", f"adapters {label}: the decode's NaN chain "
                                               f"gave the image ({p.last_decode})")
            if not timed:
                first_s = seconds
        emit("adapters", config=f"config 3: MoD img2img x4 512 -> 2048 with noise inversion, "
                                f"SD1.5 bf16, {label}", run=label, flags={}, sampler=s.name,
             steps=s.steps, denoising_strength=s.denoising_strength, cfg_scale=s.cfg_scale,
             image_cfg_scale=s.image_cfg_scale, upscaler=t.upscaler, setup_s=setup_s,
             first_image_s=first_s, seconds_per_image=seconds, img_per_min=60.0 / seconds,
             stage_seconds_per_image=dict(spent),
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             output_shape=[1, side, side, 3], finite=True, launches_per_image=launches,
             expected_launches=EXPECTED_CONFIG3, **extra)
        out[label] = launches

    # (a) StableSR guidance
    with torch.device("meta"):
        gm = StableSRGuidance(pipe.unet.cfg, dtype=bf16)
    sd = random_state_dict(gm, 7, bf16, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    for name in sd:
        if name.split(".")[0].startswith("zero"):
            sd[name] = (torch.randn(sd[name].shape, generator=gen, device=dev) * 0.02).to(bf16)
    gm.load_state_dict(sd, strict=True, assign=True)
    pipe_sr = DiffusionPipeline(pipe.unet, pipe.vae, guidance_model=gm)
    with torch.inference_mode():
        x = pipe_sr._prepare_image(img, td, None)
        g = pipe_sr._encode(x, tv)[:, :4] * pipe.vae.cfg.scaling_factor
    guidance_params = sum(p_.numel() for p_ in gm.parameters())
    run("stablesr", pipe_sr, {**cond, "guidance": g}, {**uncond, "guidance": g}, sp, td,
        guidance_parameters=guidance_params, guidance_shape=list(g.shape))
    del pipe_sr, gm, sd, g, x
    torch.cuda.empty_cache()

    # (b) ESRGAN x4 pre-upscale, through the port's writer and loader
    gcfg = RRDBNetConfig(**ESRGAN)
    tmp = tempfile.mkdtemp(prefix="_esrgan_smoke_", dir=ROOT)
    try:
        with torch.device("meta"):
            shell = RRDBNet(gcfg)
        sd = random_state_dict(shell, 8, torch.float32, dev)
        path = os.path.join(tmp, "esrgan_x4.safetensors")
        save_file({translate_esrgan_name(k.replace(".", "/")): v.cpu() for k, v in sd.items()},
                  path)
        file_bytes = os.path.getsize(path)
        model = load_esrgan(path)
        cpu_model = load_esrgan(path, device="cpu")
    finally:
        shutil.rmtree(tmp)
    require(model.cfg == gcfg, f"load_esrgan inferred {model.cfg}, wrote {gcfg}")
    crop = image_to_tensor(img)[:, :, :64, :64]
    got = esrgan_upscaler(model)(crop.to(dev), 4.0).cpu()
    ref = esrgan_upscaler(cpu_model)(crop, 4.0)
    err = (got - ref).abs().max().item()
    tol = F32_TOL * ref.abs().max().item()
    require(bool(torch.isfinite(got).all()) and err <= tol,
            f"ESRGAN 64^2 crop, card against CPU: max abs err {err} > {tol}")
    emit("adapters", check="ESRGAN x4 card against CPU, fp32, 64x64 crop", max_abs_err=err,
         tol=tol, shape=list(got.shape))
    upscale_fn = esrgan_upscaler(model)
    x512 = image_to_tensor(img).to(dev)
    upscale_fn(x512, 4.0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    upscale_fn(x512, 4.0)
    torch.cuda.synchronize()
    esrgan_s = time.perf_counter() - t1
    flops = rrdb_flops(gcfg, CFG3["image"], CFG3["image"])
    register_upscaler("SmokeESRGAN", upscale_fn)
    run("esrgan", pipe, cond, uncond, sp, dataclasses.replace(td, upscaler="SmokeESRGAN"),
        esrgan_file_bytes=file_bytes, esrgan_x4_512_seconds=esrgan_s, esrgan_flops=flops,
        esrgan_bound_s=flops / PEAK_FP32_FLOPS, esrgan_crop_max_abs_err=err)
    del model, cpu_model, upscale_fn, x512
    torch.cuda.empty_cache()

    # (c) image CFG on an SD1.5 UNet with 8 input channels
    with torch.device("meta"):
        unet8 = UNet2DCondition(dataclasses.replace(sd15_unet_config(), in_channels=8),
                                dtype=bf16)
    unet8.load_state_dict(random_state_dict(unet8, 9, bf16, dev), strict=True, assign=True)
    pipe_e = DiffusionPipeline(unet8, pipe.vae)
    run("image_cfg", pipe_e, cond, uncond, dataclasses.replace(sp, image_cfg_scale=1.5), td)
    del pipe_e, unet8, pipe, cond, uncond
    torch.cuda.empty_cache()
    return out


def phase_unclip():
    """SD2.1-unCLIP (``sd21_unclip_unet_config("h")``, random bf16 weights
    drawn on the card) with the SD VAE on config 2's canvas, sampler and
    tiles: crossattn [1, 77, 1024], adm [1, 2048]; 1 warm and 1 timed
    image, #1's launches at D = 64 pinned. Returns the launches per image."""
    import torch

    from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig,
                               TiledDiffusionConfig, TiledVAEConfig)
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, VAEConfig,
                                      random_state_dict, sd21_unclip_unet_config)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t0 = time.perf_counter()
    ucfg = sd21_unclip_unet_config("h")
    with torch.device("meta"):
        unet = UNet2DCondition(ucfg, dtype=bf16)
        vae = AutoencoderKL(VAEConfig(), dtype=bf16)
    unet.load_state_dict(random_state_dict(unet, 10, bf16, dev), strict=True, assign=True)
    vae.load_state_dict(random_state_dict(vae, 1, bf16, dev), strict=True, assign=True)
    pipe = DiffusionPipeline(unet, vae)
    gen = torch.Generator(device=dev).manual_seed(2)
    adm = (torch.randn(1, ucfg.adm_in_channels, generator=gen, device=dev) * 0.1).to(bf16)
    cond = {"crossattn": (torch.randn(1, 77, 1024, generator=gen, device=dev) * 0.1).to(bf16),
            "adm": adm}
    uncond = {"crossattn": (torch.randn(1, 77, 1024, generator=gen, device=dev)
                            * 0.1).to(bf16), "adm": adm}
    sp = SamplerConfig(name="Euler", steps=CFG2["steps"], cfg_scale=CFG2["cfg"])
    td = TiledDiffusionConfig(method=Method.MULTI_DIFF, tile_w=CFG2["tile"],
                              tile_h=CFG2["tile"], overlap=CFG2["overlap"],
                              tile_bs=CFG2["tile_bs"])
    tv = TiledVAEConfig(decoder_tile_size=CFG2["decoder_tile"], fast_decoder=False)
    setup_s = time.perf_counter() - t0
    launches, fields = run_config2(pipe, cond, uncond, sp, td, tv, EXPECTED_UNCLIP, "unclip",
                                   n=1)
    emit("unclip", config="SD2.1-unCLIP (ViT-H adm) on config 2: MultiDiffusion txt2img "
                          "2048x512, bf16", run="default", flags={}, sampler=sp.name,
         steps=sp.steps, cfg_scale=sp.cfg_scale, adm_in_channels=ucfg.adm_in_channels,
         head_dim=ucfg.head_dim, setup_s=setup_s, expected_launches=EXPECTED_UNCLIP, **fields)
    del pipe, unet, vae, cond, uncond
    torch.cuda.empty_cache()
    return launches


def _tiny_deepcache(name):
    """The tiny pipeline under DeepCache N = 2 on a tiled txt2img with a
    BACKGROUND region (the 32 x 64 latent of ``_tiny_run``, tiles of 32: 1024
    tokens at level 0), sampler ``name``, 4 steps, the base noise, the
    region's patch and the samplers' noise drawn on the CPU. Returns
    ``run(device, dtype) -> (latents,)``."""

    def run(device, dtype):
        import torch

        from mdu_tpu_torch import SamplerConfig, TiledDiffusionConfig
        from mdu_tpu_torch.tiling.regions import compose_region_noise
        from mdu_tpu_torch.utils.bbox import RegionSpec

        pipe, c, u, gen = _tiny_pipeline(device, dtype)
        rc = (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)
        region = RegionSpec(0.0, 0.0, 0.5, 1.0, seed=31)
        noise = compose_region_noise(torch.randn(1, 4, 32, 64, generator=gen),
                                     [region.to_bbox(64, 32)], [31])
        td = TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16, tile_bs=3, regions=[region])
        res = pipe._txt2img_from_noise(noise, c, u, SamplerConfig(name=name, steps=4,
                                                                   deepcache=2), 0, td,
                                       decode=False, region_conds=[({"crossattn": rc}, u)],
                                       region_seeds=[31],
                                       sampler_noise=torch.Generator().manual_seed(9))
        return (res.latents.float().cpu(),)

    return run


def _tiny_demofusion_dc(device: str, dtype):
    """``_tiny_demofusion`` under DeepCache N = 2 (the global views cached)
    with an AND cond of two branches (weights 1 and 0.5), Euler 4 steps.
    Returns (phase 1 latent, phase 2 latent) on the CPU in fp32."""
    import torch

    from mdu_tpu_torch import DemoFusionConfig, SamplerConfig

    pipe, c, u, gen = _tiny_sdxl_pipeline(device, dtype)
    c2 = {**c, "crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.5).to(dtype)}
    base = torch.randn(1, 4, 48, 48, generator=gen)
    phase = torch.randn(1, 4, 96, 96, generator=gen)
    cfg = DemoFusionConfig(window_size=48, overlap=24, tile_bs=4, tile_bs_g=2, scale_factor=2)
    res = pipe._demofusion_from_noise(base, [phase], {"__and__": [c, c2],
                                                      "__weights__": (1.0, 0.5)}, u, 384, 384,
                                      cfg, SamplerConfig(steps=4, denoising_strength=0.6,
                                                         deepcache=2), seed=3, decode=False)
    return tuple(p.float().cpu() for p in res.phase_latents)


def _fill_zero_gates(sd, gen, dtype, scale=0.3):
    """``sd`` with every ``zero*`` gate (and a ControlNet's
    ``cond_embedding.conv_out``) drawn from a normal of std ``scale``."""
    import torch

    for name in sd:
        if name.split(".")[0].startswith("zero") or name.startswith("cond_embedding.conv_out"):
            sd[name] = (torch.randn(sd[name].shape, generator=gen) * scale).to(dtype)
    return sd


def _tiny_img2img_adapter(kind):
    """A tiny tiled img2img of a 256 x 512 image (upscaler None, untiled
    encode; MultiDiffusion over the 32 x 64 latent in tiles of 32), Euler 4
    steps at denoise 0.75, with ``kind``: "stablesr" (the tiny UNet with a
    ControlNet and a StableSR guidance encoder, every gate drawn nonzero; a
    guidance latent and a hint on cond and uncond) or "image_cfg" (the tiny
    UNet with 8 input channels, image CFG 1.5, the image latent attached by
    the pipeline). Weights, images and noise drawn on the CPU. Returns
    ``run(device, dtype) -> (latents,)``."""

    def run(device, dtype):
        import dataclasses

        import numpy as np
        import torch

        from mdu_tpu_torch import DiffusionPipeline, SamplerConfig, TiledDiffusionConfig
        from mdu_tpu_torch.models import (AutoencoderKL, ControlNet, StableSRGuidance,
                                          UNet2DCondition, random_state_dict,
                                          tiny_unet_config, tiny_vae_config)

        gen = torch.Generator().manual_seed(13)
        ucfg = tiny_unet_config()
        if kind == "image_cfg":
            ucfg = dataclasses.replace(ucfg, in_channels=8)
        unet, vae = UNet2DCondition(ucfg, dtype=dtype), AutoencoderKL(tiny_vae_config(),
                                                                       dtype=dtype)
        unet.load_state_dict(random_state_dict(unet, 0, dtype, device="cpu"))
        vae.load_state_dict(random_state_dict(vae, 1, dtype, device="cpu"))
        c = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
        u = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
        kw, sp = {}, SamplerConfig(steps=4, denoising_strength=0.75)
        if kind == "stablesr":
            cn, gm = ControlNet(ucfg, dtype=dtype), StableSRGuidance(ucfg, dtype=dtype)
            cn.load_state_dict(_fill_zero_gates(random_state_dict(cn, 2, dtype, device="cpu"),
                                                gen, dtype))
            gm.load_state_dict(_fill_zero_gates(random_state_dict(gm, 3, dtype, device="cpu"),
                                                gen, dtype, 0.05))
            kw = dict(controlnet=cn, guidance_model=gm)
            extra = {"guidance": torch.randn(1, 4, 32, 64, generator=gen) * 0.3,
                     "control": [torch.rand(1, 3, 256, 512, generator=gen)]}
            c, u = {**c, **extra}, {**u, **extra}
        else:
            sp = dataclasses.replace(sp, image_cfg_scale=1.5)
        pipe = DiffusionPipeline(unet, vae, device=device, **kw)
        img = (np.random.default_rng(14).random((256, 512, 3)) * 255).astype(np.uint8)
        enc_noise = torch.randn(1, 4, 32, 64, generator=gen).to(dtype)
        noise = torch.randn(1, 4, 32, 64, generator=gen)
        td = TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16, tile_bs=3)
        res = pipe._img2img_from_noise(img, enc_noise, noise, c, u, sp, 0, td, decode=False)
        return (res.latents.float().cpu(),)

    return run


def _tiny_unclip(device: str, dtype):
    """The tiny UNet with an 8-wide ``adm`` on ``_tiny_run``'s tiled txt2img
    (Euler 3 steps), weights, embeddings and noise drawn on the CPU. Returns
    (latents,)."""
    import dataclasses

    import torch

    from mdu_tpu_torch import DiffusionPipeline, SamplerConfig, TiledDiffusionConfig
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, random_state_dict,
                                      tiny_unet_config, tiny_vae_config)

    ucfg = dataclasses.replace(tiny_unet_config(), adm_in_channels=8)
    unet = UNet2DCondition(ucfg, dtype=dtype)
    unet.load_state_dict(random_state_dict(unet, 0, dtype, device="cpu"))
    pipe = DiffusionPipeline(unet, AutoencoderKL(tiny_vae_config(), dtype=dtype), device=device)
    gen = torch.Generator().manual_seed(15)
    adm = (torch.randn(1, 8, generator=gen) * 0.5).to(dtype)
    c = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype), "adm": adm}
    u = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype), "adm": adm}
    res = pipe._txt2img_from_noise(torch.randn(1, 4, 32, 64, generator=gen), c, u,
                                   SamplerConfig(steps=3), 0,
                                   TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16,
                                                        tile_bs=3), decode=False)
    return (res.latents.float().cpu(),)


def _tiny_esrgan(device: str, dtype):
    """The tiny RRDBNet (weights drawn on the CPU) as an x4 upscaler of a 64
    x 64 image in [-1, 1]. Returns (image,)."""
    import torch

    from mdu_tpu_torch.models import RRDBNet, random_state_dict, tiny_rrdb_config
    from mdu_tpu_torch.models.esrgan import esrgan_upscaler

    model = RRDBNet(tiny_rrdb_config(), dtype=dtype)
    model.load_state_dict(random_state_dict(model, 4, torch.float32, device="cpu"))
    model = model.to(device)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(16)) * 2 - 1
    return (esrgan_upscaler(model)(x.to(device), 4.0).float().cpu(),)


def _adapter_runs():
    """``phase_reference_adapters``' runs: (label, the ``_cpu_refs`` spec,
    parts, the kernels each card run must launch by dtype)."""
    import torch

    fm = {torch.float32: ["flash_attention_fm_f32"], torch.bfloat16: ["flash_attention_fm"]}
    runs = [(f"DeepCache {name}", ("_tiny_deepcache", (name,)), ("latent",), fm)
            for name in ("Euler", "Heun", "Euler a")]
    runs += [("DemoFusion DeepCache + AND", ("_tiny_demofusion_dc", None),
              ("phase1_latent", "latent"), fm),
             ("StableSR + ControlNet img2img", ("_tiny_img2img_adapter", ("stablesr",)),
              ("latent",), fm),
             ("image CFG img2img", ("_tiny_img2img_adapter", ("image_cfg",)), ("latent",), fm),
             ("unCLIP", ("_tiny_unclip", None), ("latent",), fm),
             ("ESRGAN x4", ("_tiny_esrgan", None), ("image",),
              {torch.float32: [], torch.bfloat16: []})]
    return runs


def phase_reference_adapters(get=None):
    """This slice's tiny paths on the card against the CPU, held as
    ``_hold_to_cpu`` holds them (fp32 within 1e-4 of the largest CPU value,
    bf16 within 2x the CPU bf16 run's error + 1e-3 of it): DeepCache N = 2 on
    a tiled txt2img with a BACKGROUND region under Euler, Heun and Euler a; a
    DemoFusion x2 with DeepCache and an AND cond; StableSR + ControlNet on a
    tiled img2img; image CFG 1.5; unCLIP; a tiny ESRGAN upscale (no kernel:
    its convs are cuDNN's). Each card run of a UNet must launch its #1.
    ``get`` reads the CPU runs, as in ``phase_reference``."""
    import torch

    runs = _adapter_runs()
    get = get or _submit_refs(None, [(spec, {}) for _, spec, _, _ in runs])
    for i, (label, (fn, args), parts, must) in enumerate(runs):
        run = globals()[fn] if args is None else globals()[fn](*args)
        refs, _, _, cpu_s = get(i)
        for dtype, fields in _hold_to_cpu(f"tiny {label}", run, parts, must,
                                          cpu=(refs, cpu_s)).items():
            emit("reference", dtype=_dtype_name(dtype), pipeline=f"tiny {label}", flags={},
                 **fields)


# ------------------------------------------------ streaming VAE, prompts, checkpoints


def synth_vocab(vocab_size: int):
    """A char-level CLIP vocab: every byte's character alone and word-final,
    no merges (a whole-word vocab would send every word to <eot>), bos and
    eot at the top of the id space. Returns (vocab, merges)."""
    from mdu_tpu_torch.text.tokenizer import bytes_to_unicode

    chars = sorted(set(bytes_to_unicode().values()))
    vocab = {ch: i for i, ch in enumerate(chars)}
    vocab.update({ch + "</w>": len(chars) + i for i, ch in enumerate(chars)})
    vocab.update({"<|startoftext|>": vocab_size - 2, "<|endoftext|>": vocab_size - 1})
    return vocab, []


def cond_tensors(c):
    """Every tensor of a cond (plain, bank or AND), in order, flattened into
    one fp32 CPU vector."""
    import torch

    out = []

    def walk(x):
        if isinstance(x, dict):
            for key in sorted(x):
                if key not in ("__index__", "__weights__"):
                    walk(x[key])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            out.append(x.detach().float().cpu().reshape(-1))

    walk(c)
    return torch.cat(out)


def _hold_parts(label, got, ref, own_err, dtype):
    """``got`` parts against ``ref`` parts: fp32 within 1e-4 of the largest
    reference value, a reduced precision within 2x ``own_err`` (the CPU's
    own error in that precision) + 1e-3 of it. Returns the fields."""
    import torch

    fields = {}
    for name in ref:
        scale = ref[name].abs().max().item()
        err = (got[name] - ref[name]).abs().max().item()
        tol = 1e-4 * scale if own_err is None else 2.0 * own_err[name] + 1e-3 * scale
        require(bool(torch.isfinite(got[name]).all()), f"{label} {dtype} {name}: non-finite")
        require(err <= tol, f"{label} {dtype} {name}: max abs err {err} > {tol}")
        fields.update({f"{name}_max_abs_err": err, f"{name}_tol": tol})
    return fields


def _tiny_vae(device, dtype):
    """The tiny VAE with random weights drawn on the CPU."""
    from mdu_tpu_torch.models import AutoencoderKL, random_state_dict, tiny_vae_config

    vae = AutoencoderKL(tiny_vae_config(), dtype=dtype)
    vae.load_state_dict(random_state_dict(vae, 1, dtype, device="cpu"))
    return vae.to(device).eval()


def _tiny_stream(host_resident, spill):
    """The streaming decode of a 48 x 48 latent at tile 24 (4 tiles of 46:
    2116 tokens at the mid-block) and encode of a 384 x 384 image at tile 192
    (4 tiles of 256 px: 1024 tokens), groups of 2, on the tiny VAE.
    Returns ``run(device, dtype) -> {"image", "moments"}`` on the CPU in fp32."""

    def run(device, dtype):
        import torch

        from mdu_tpu_torch.tiling.streaming_vae import streaming_tiled_vae

        vae = _tiny_vae(device, dtype)
        gen = torch.Generator().manual_seed(12)
        z = (torch.randn(1, 4, 48, 48, generator=gen) * 0.5).to(device)
        x = (torch.rand(1, 3, 384, 384, generator=gen) * 2 - 1).to(device)
        kw = dict(group_size=2, host_resident=host_resident, spill_dtype=spill)
        return {"image": streaming_tiled_vae(vae, z, "decoder", 24, **kw).float().cpu(),
                "moments": streaming_tiled_vae(vae, x, "encoder", 192, **kw).float().cpu()}

    return run


# every branch and the uncond in two chunks: AND branches are batched, so
# their chunk counts must agree, as in the JAX package
PROMPT_TINY = ("a (red:1.3) cat BREAK under a [sunny:rainy:2] sky AND a hat BREAK on a "
               "table:0.5", "blurry BREAK lowres")


def _tiny_prompt(device, dtype):
    """The tiny CLIP (random weights drawn on the CPU, a char-level vocab) on
    a prompt with emphasis, BREAK, a schedule and AND, then the tiny
    pipeline's txt2img from it (the 32 x 64 latent of ``_tiny_run``, Euler 3
    steps, no decode). Returns {"conds", "latent"} on the CPU in fp32."""
    import torch

    from mdu_tpu_torch import SamplerConfig, TiledDiffusionConfig
    from mdu_tpu_torch.models.clip import CLIPTextModel, tiny_clip_config
    from mdu_tpu_torch.text import CLIPTokenizer, TextConditioner

    cfg = tiny_clip_config()
    clip = CLIPTextModel(cfg, dtype=dtype)
    clip.load_state_dict(_clip_weights(clip, 3, dtype, "cpu"))
    tc = TextConditioner(clip, CLIPTokenizer(*synth_vocab(cfg.vocab_size),
                                             max_length=cfg.max_length), device=device)
    cond, uncond = tc.pair(*PROMPT_TINY, steps=3)
    pipe, _, _, gen = _tiny_pipeline(device, dtype)
    noise = torch.randn(1, 4, 32, 64, generator=gen)
    res = pipe._txt2img_from_noise(noise, cond, uncond, SamplerConfig(steps=3), 0,
                                   TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16,
                                                        tile_bs=3), decode=False)
    return {"conds": torch.cat([cond_tensors(cond), cond_tensors(uncond)]),
            "latent": res.latents.float().cpu()}


def _kohya_lora(state_dict, names, rank, gen):
    """A kohya LoRA over the ``state_dict`` entries ``names`` (linear or conv
    weights): up and down drawn from ``gen`` on the CPU, alpha = rank / 2."""
    import torch

    from mdu_tpu_torch.models.loader import translate_unet_name

    lora = {}
    for name in names:
        w = state_dict[name]
        base = translate_unet_name(name.replace(".", "/"))[:-len(".weight")].replace(".", "_")
        lora[f"lora_unet_{base}.lora_down.weight"] = torch.randn(
            (rank,) + tuple(w.shape[1:]), generator=gen) * 0.05
        lora[f"lora_unet_{base}.lora_up.weight"] = torch.randn(
            (w.shape[0], rank) + (1, 1)[:w.dim() - 2], generator=gen) * 0.05
        lora[f"lora_unet_{base}.alpha"] = torch.tensor(rank / 2.0)
    return lora


def _lora_reference(w, lora, name, scale):
    """W + scale * (alpha / r) * up @ down in fp32 on the CPU."""
    from mdu_tpu_torch.models.loader import translate_unet_name

    base = translate_unet_name(name.replace(".", "/"))[:-len(".weight")].replace(".", "_")
    down = lora[f"lora_unet_{base}.lora_down.weight"].float()
    up = lora[f"lora_unet_{base}.lora_up.weight"].float()
    r = down.shape[0]
    eff = scale * float(lora[f"lora_unet_{base}.alpha"]) / r
    return w.float().cpu() + eff * (up.reshape(up.shape[0], -1)
                                    @ down.reshape(r, -1)).reshape(w.shape)


TINY_LORA_NAMES = ["down_0_attn_0.block_0.attn1.to_q.weight", "mid_res_0.conv1.weight"]


def _tiny_load(device, dtype):
    """The tiny pipeline's modules and the tiny CLIP written as one SD1.x
    single-file checkpoint (LDM names, the port's writer) into a temporary
    directory of the checkout, loaded back with ``load_single_file`` (every
    tensor must equal its source), a rank-2 kohya LoRA merged at scale 0.8,
    then the tiny txt2img (Euler 3 steps, no decode) from the loaded pipeline
    with the merged UNet. Returns {"merged", "latent"} on the CPU in fp32."""
    import shutil
    import tempfile

    import torch

    from mdu_tpu_torch import SamplerConfig
    from mdu_tpu_torch.models import tiny_unet_config, tiny_vae_config
    from mdu_tpu_torch.models.clip import CLIPTextModel, tiny_clip_config
    from mdu_tpu_torch.models.lora import merge_lora
    from mdu_tpu_torch.models.safetensors import save_file
    from mdu_tpu_torch.models.single_file import ldm_state_dict, load_single_file

    pipe, c, u, gen = _tiny_pipeline(device, dtype)
    clip = CLIPTextModel(tiny_clip_config(), dtype=dtype)
    clip.load_state_dict(_clip_weights(clip, 3, dtype, "cpu"))
    tmp = tempfile.mkdtemp(dir=ROOT, prefix="_load_smoke_")
    try:
        path = os.path.join(tmp, "tiny.safetensors")
        save_file(ldm_state_dict(pipe.unet, pipe.vae, clip), path)
        lpipe, lcond = load_single_file(path, dtype=dtype, device=device,
                                        unet_config=tiny_unet_config(),
                                        vae_config=tiny_vae_config(),
                                        clip_config=tiny_clip_config())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for src, dst in ((pipe.unet, lpipe.unet), (pipe.vae, lpipe.vae), (clip, lcond.model)):
        a, b = src.state_dict(), dst.state_dict()
        require(set(a) == set(b) and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a),
                f"tiny single file {dtype}: a loaded tensor differs from its source")
    lora = _kohya_lora(lpipe.unet.state_dict(), TINY_LORA_NAMES, 2,
                       torch.Generator().manual_seed(4))
    merged = merge_lora(lpipe.unet.state_dict(), lora, 0.8)
    lpipe.unet.load_state_dict(merged)
    noise = torch.randn(1, 4, 32, 32, generator=gen)
    res = lpipe._txt2img_from_noise(noise, c, u, SamplerConfig(steps=3), 0, None, decode=False)
    return {"merged": torch.cat([merged[k].float().cpu().reshape(-1) for k in TINY_LORA_NAMES]),
            "latent": res.latents.float().cpu()}


def phase_reference_slice():
    """This slice's tiny paths on the card against the CPU: the streaming
    decode and encode (stream-device, stream-host, and stream-host with fp8
    spills), the tiny conditioner and a txt2img from its prompt, the tiny
    single-file round trip with a LoRA merge. fp32 within 1e-4 of the largest
    CPU value, bf16 within 2x the CPU bf16 run's error against the CPU fp32
    run + 1e-3 of it; the fp8 runs (either dtype) against the CPU's fp32
    stream-host run without spills, within 2x the CPU fp8 run's error
    against it + 1e-3 of it. Each card run must launch its attention kernel
    (the VAE's and the UNet's heads are D = 16: #1)."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    must = {torch.float32: "flash_attention_fm_f32", torch.bfloat16: "flash_attention_fm"}
    exact_host = _tiny_stream(True, None)("cpu", torch.float32)
    runs = [("stream-device", _tiny_stream(False, None), None),
            ("stream-host", _tiny_stream(True, None), None),
            ("stream-host fp8", _tiny_stream(True, "float8_e4m3fn"), exact_host),
            ("conditioner + txt2img", _tiny_prompt, None),
            ("single file + LoRA", _tiny_load, None)]
    for label, run, fixed_ref in runs:
        ref = fixed_ref or run("cpu", torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            if fixed_ref is not None:
                own = {k: max((run("cpu", d)[k] - ref[k]).abs().max().item()
                               for d in (torch.float32, torch.bfloat16)) for k in ref}
            elif dtype == torch.bfloat16:
                cpu = run("cpu", dtype)
                own = {k: (cpu[k] - ref[k]).abs().max().item() for k in ref}
            else:
                own = None
            reset_launches()
            got = run("cuda", dtype)
            launches = dict(LAUNCHES)
            require(launches.get(must[dtype], 0) > 0, f"tiny {label} {dtype}: no {must[dtype]}")
            fields = _hold_parts(f"tiny {label}", got, ref, own, dtype)
            emit("reference", dtype=_dtype_name(dtype), pipeline=f"tiny {label}", flags={},
                 launches=launches, **fields)


def _budget_env(budget):
    return flags_set({"MDU_HBM_BYTES": str(int(budget))})


# config 3's exact VAE (bench.py:345-377): decode a 256 x 256 latent at tile 64
# (16 tiles of 86: 7396 tokens at the mid-block), encode 2048 x 2048 at tile
# 1024 (4 tiles of 1056: 17424 tokens)
STREAM = dict(latent=256, image=2048, decoder_tile=64, encoder_tile=1024, tile_batch=2,
              host_budget=4 * 2 ** 30, ref_budget=8 * 2 ** 30)


def _stream_groups(pipe, which, side, tile, tv, host_resident, dtype_bytes=2):
    """The group the streaming mode will take, and the number of groups."""
    import torch

    from mdu_tpu_torch.tiling import streaming_vae as sv
    from mdu_tpu_torch.tiling.tiled_vae import DECODER_PAD, ENCODER_PAD, plan_vae_tiles

    pad = DECODER_PAD if which == "decoder" else ENCODER_PAD
    plan = plan_vae_tiles(side, side, tile, pad)
    s = 8 if which == "decoder" else 1
    g, _ = sv.auto_group_size(which, plan.in_h * s, plan.in_w * s, 1,
                              min(tv.tile_batch, plan.num_tiles), host_resident, dtype_bytes,
                              torch.device("cuda"))
    return g, -(-plan.num_tiles // g), plan


def phase_stream():
    """Config 3's exact decode and encode (SD VAE at full width, random bf16
    weights) in lockstep, stream-device, stream-host and stream-host with fp8
    spills, each mode forced through an ``MDU_HBM_BYTES`` budget and the mode
    the pipeline picked checked (config 3's encode cannot pick stream-device:
    its lockstep footprint is below it, so that run calls the streaming mode
    directly). The reference is a stream-host run of the same weights in
    fp32 (device memory bounded by construction). Each bf16 mode within 2x
    |bf16 lockstep - fp32 reference| + 1e-3 of its largest value; fp8's mean
    absolute error against the bf16 stream-host under 0.12 on the decode's
    [-1, 1] image (and under 0.12 of the largest moment on the encode). #2
    launches once a group at the attention segment (once in lockstep).
    Returns the launches of each run."""
    import torch

    from mdu_tpu_torch import TiledVAEConfig
    from mdu_tpu_torch.models import AutoencoderKL, VAEConfig
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.tiling.streaming_vae import streaming_tiled_vae
    from mdu_tpu_torch.tiling.tiled_vae import (lockstep_footprint_bytes,
                                                streaming_device_footprint_bytes)

    pipe, *_ = build_config2()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    z = torch.randn(1, 4, STREAM["latent"], STREAM["latent"], generator=gen, device=dev)
    x = torch.rand(1, 3, STREAM["image"], STREAM["image"], generator=gen, device=dev) * 2 - 1
    vae32 = AutoencoderKL(VAEConfig(), dtype=torch.float32).to(dev).eval()
    vae32.load_state_dict({k: v.float() for k, v in pipe.vae.state_dict().items()})
    scale = pipe.vae.cfg.scaling_factor
    inputs = {"decoder": (z, STREAM["latent"], STREAM["decoder_tile"]),
              "encoder": (x, STREAM["image"], STREAM["encoder_tile"])}
    out = {}
    for which, (arr, side, tile) in inputs.items():
        tv = TiledVAEConfig(decoder_tile_size=STREAM["decoder_tile"],
                            encoder_tile_size=STREAM["encoder_tile"], fast_decoder=False,
                            fast_encoder=False, tile_batch=STREAM["tile_batch"])
        run = ((lambda t: pipe._decode_tensor(z, t)) if which == "decoder"
               else (lambda t: pipe._encode(x, t)))
        with _budget_env(STREAM["ref_budget"]):
            g, n_ref, plan = _stream_groups(pipe, which, side, tile, tv, True, 4)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ref = streaming_tiled_vae(vae32, z / scale if which == "decoder" else x, which,
                                      tile, tv.tile_batch, host_resident=True).float()
            torch.cuda.synchronize()
        emit("stream", which=which, run="fp32 reference (stream-host)", group=g, groups=n_ref,
             seconds=time.perf_counter() - t0,
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        lock_fp = lockstep_footprint_bytes(which, tile, plan.num_tiles, 1)
        dev_fp = streaming_device_footprint_bytes(which, tile, plan.num_tiles, 1, tv.tile_batch)
        # (label, budget, spill dtype, tiles a group asked for); stream-host asks
        # for 4 and the budget clamps the group
        runs = [("lockstep", 2 ** 40, None, 2),
                ("stream-device", (lock_fp + dev_fp) // 2, None, 2),
                ("stream-host", STREAM["host_budget"], None, 4),
                ("stream-host fp8", STREAM["host_budget"], "float8_e4m3fn", 4)]
        results, lock_err = {}, None
        for label, budget, spill, tile_batch in runs:
            mode = label.split(" ")[0]
            tvr = dataclasses.replace(tv, spill_dtype=spill, tile_batch=tile_batch)
            by_rule = not (mode == "stream-device" and dev_fp > lock_fp)
            with _budget_env(budget):
                groups = (1 if mode == "lockstep" else
                          _stream_groups(pipe, which, side, tile, tvr, mode == "stream-host")[1])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                if by_rule:
                    got = run(tvr)
                    picked = pipe.last_vae_mode
                else:
                    got = pipe._stream_vae(which, arr, tvr, host_resident=False)
                    picked = None
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            if by_rule:
                require(picked == mode, f"stream {which} {label}: the pipeline picked {picked}")
            require(launches.get("flash_attention", 0) == groups,
                    f"stream {which} {label}: #2 launched {launches.get('flash_attention')} "
                    f"times, expected {groups}")
            got = got.float()
            require(tuple(got.shape) == tuple(ref.shape) and bool(torch.isfinite(got).all()),
                    f"stream {which} {label}: output {tuple(got.shape)} or non-finite")
            results[label] = got
            err = (got - ref).abs().max().item()
            fields = dict(max_abs_err_vs_fp32=err)
            if label == "lockstep":
                lock_err = err
            if spill is None:
                tol = 2.0 * lock_err + 1e-3 * ref.abs().max().item()
                require(err <= tol, f"stream {which} {label}: max abs err {err} > {tol}")
                fields["tol"] = tol
            else:
                host = results["stream-host"]
                if which == "decoder":
                    mean_err = (got.clamp(-1, 1) - host.clamp(-1, 1)).abs().mean().item()
                    bar = 0.12
                else:
                    mean_err = (got - host).abs().mean().item()
                    bar = 0.12 * host.abs().max().item()
                require(mean_err < bar, f"stream {which} {label}: mean abs err {mean_err} "
                                        f"against bf16 stream-host >= {bar}")
                fields.update(mean_abs_err_vs_stream_host=mean_err, mean_bar=bar)
            emit("stream", which=which, run=label, budget_bytes=budget, mode_picked=picked,
                 picked_by_rule=by_rule, spill_dtype=spill, groups=groups,
                 lockstep_footprint_bytes=lock_fp, stream_device_footprint_bytes=dev_fp,
                 seconds=seconds, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 launches=launches, output_shape=list(got.shape), **fields)
            out[f"{which} {label}"] = launches
        del results, ref
    del pipe, vae32, z, x
    torch.cuda.empty_cache()
    return out


PROMPTS_CONFIG2 = [
    ("plain", "a watercolor panorama of a mountain lake at dawn, highly detailed",
     "blurry, lowres"),
    ("schedule + AND", "a [quiet:stormy:8] mountain lake at dawn AND a (red:1.2) boat:0.6",
     "blurry, lowres")]


def _clip_weights(clip, seed, dtype, device):
    """Random CLIP weights (``random_state_dict``) with the final LayerNorm's
    bias drawn too: with a zero bias every state has a mean of about 0, and
    A1111's mean restoration after emphasis (mean before / mean after) would
    divide rounding noise by rounding noise, as no trained CLIP does."""
    import torch

    from mdu_tpu_torch.models import random_state_dict

    sd = random_state_dict(clip, seed, dtype, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    sd["ln_final.bias"] = torch.randn(sd["ln_final.bias"].shape, generator=gen,
                                      device=device).to(dtype)
    return sd


def _conditioner(cfg, seed, dtype, device, pad_with_eot=True):
    """A TextConditioner over a CLIP of ``cfg`` with random weights drawn on
    ``device``, and the char-level vocab."""
    import torch

    from mdu_tpu_torch.models.clip import CLIPTextModel
    from mdu_tpu_torch.text import CLIPTokenizer, TextConditioner

    with torch.device("meta"):
        clip = CLIPTextModel(cfg, dtype=dtype)
    clip.load_state_dict(_clip_weights(clip, seed, dtype, device), assign=True)
    tok = CLIPTokenizer(*synth_vocab(cfg.vocab_size), pad_with_eot=pad_with_eot)
    return TextConditioner(clip, tok, device=device)


def phase_prompts():
    """Config 2 (bf16, no flag) from prompt strings through a full-width
    CLIP-L with random bf16 weights: a plain prompt, and a scheduled prompt
    with an AND of two weighted branches (the AND batches cond, cond and
    uncond: 15 tiles a UNet call). Each encode's ms; the card's conds held
    to the CPU conditioner on the same weights (fp32 and bf16: the bf16 bar);
    1 warm and 1 timed image each, launches pinned (#1 200, #2 1). Then the
    SDXL conditioner (CLIP-L and OpenCLIP-bigG at full width, random bf16
    weights) on one pair: shapes, ms, finite. Returns the launches of each
    prompt's image."""
    import torch

    from mdu_tpu_torch.models.clip import clip_l_config, open_clip_bigg_config
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.text import SDXLConditioner, TextConditioner

    pipe, _, _, sp, td, tv = build_config2()
    tc = _conditioner(clip_l_config(), 3, torch.bfloat16, torch.device("cuda"))
    cpu = {d: TextConditioner(type(tc.model)(tc.model.cfg, dtype=d), tc.tokenizer, device="cpu")
           for d in (torch.float32, torch.bfloat16)}
    for d, c in cpu.items():
        c.model.load_state_dict({k: v.to("cpu", d) for k, v in tc.model.state_dict().items()})
    expected = {"flash_attention_fm": 200, "flash_attention_fm.sm90": 200,
                "flash_attention": 1, "flash_attention.wide": 1}
    out = {}
    for label, text, neg in PROMPTS_CONFIG2:
        tc.pair(text, neg, steps=sp.steps)                      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cond, uncond = tc.pair(text, neg, steps=sp.steps)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        got = torch.cat([cond_tensors(cond), cond_tensors(uncond)])
        ref, ref16 = (torch.cat([cond_tensors(c) for c in cpu[d].pair(text, neg, steps=sp.steps)])
                      for d in (torch.float32, torch.bfloat16))
        fields = _hold_parts(f"prompts {label}", {"conds": got}, {"conds": ref},
                             {"conds": (ref16 - ref).abs().max().item()}, torch.bfloat16)

        def image(seed):
            res = pipe.txt2img(cond, uncond, width=CFG2["width"], height=CFG2["height"],
                               sampler=sp, seed=seed, tiled_diffusion=td, tiled_vae=tv)
            torch.cuda.synchronize()
            require(tuple(res.images.shape) == (1, 512, 2048, 3)
                    and bool(torch.isfinite(res.latents).all()),
                    f"prompts {label}: output {tuple(res.images.shape)} or non-finite")
            return res

        reset_launches()
        t0 = time.perf_counter()
        image(0)
        first_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want = {k: expected.get(k, 0) for k in launches}
        require(launches == want, f"prompts {label}: launches {launches}, expected {want}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        image(1)
        timed_s = time.perf_counter() - t0
        structure = ("AND of " + str(len(cond["__and__"])) if "__and__" in cond
                     else "bank" if "__bank__" in cond else "plain")
        emit("prompts", config="config 2 from prompt strings: CLIP-L (random bf16 weights) + "
                               "MultiDiffusion txt2img 2048x512, SD1.5 bf16", run=label,
             prompt=text, negative=neg, cond_form=structure, encode_ms=encode_ms,
             first_image_s=first_s, seconds_per_image=timed_s, img_per_min=60.0 / timed_s,
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             launches_per_image=launches, expected_launches=expected, **fields)
        out[label] = launches
    del pipe, tc, cpu
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    te1 = _conditioner(dataclasses.replace(clip_l_config(), clip_skip=2, ln_penultimate=False),
                       4, torch.bfloat16, dev)
    te2 = _conditioner(open_clip_bigg_config(), 5, torch.bfloat16, dev, pad_with_eot=False)
    sx = SDXLConditioner(te1, te2)
    sx.pair(*PROMPTS_CONFIG2[0][1:], 1024, 1024)               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cond, uncond = sx.pair(*PROMPTS_CONFIG2[0][1:], 1024, 1024)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    require(tuple(cond["crossattn"].shape) == (1, 77, 2048)
            and tuple(cond["vector"].shape) == (1, 1280)
            and tuple(cond["time_ids"].shape) == (1, 6),
            f"SDXL conditioner: shapes {[tuple(v.shape) for v in cond.values()]}")
    require(all(bool(torch.isfinite(v).all()) for c in (cond, uncond) for v in c.values()),
            "SDXL conditioner: non-finite conds")
    emit("prompts", run="SDXL conditioner (CLIP-L + OpenCLIP-bigG, random bf16 weights)",
         pair_ms=ms, shapes={k: list(v.shape) for k, v in cond.items()}, finite=True,
         time_ids=cond["time_ids"].tolist())
    del sx, te1, te2
    torch.cuda.empty_cache()
    return out


LOAD_LORA_NAMES = ["down_0_attn_0.block_0.attn1.to_q.weight",
                   "mid_attn.block_0.attn2.to_k.weight", "up_3_res_2.conv2.weight"]


def phase_load():
    """A full-width SD1.5 single-file checkpoint (LDM names, BF16) of config
    2's random weights and a random CLIP-L, with a char-level ``tokenizer/``
    folder and a rank-8 kohya LoRA, written with the port's writer into a
    temporary directory of the checkout (deleted afterwards) and loaded with
    ``load_single_file``: every tensor equal to its source bit for bit; a
    config-2 image from the loaded pipeline equal to the in-memory
    pipeline's (two runs of the in-memory one show the card's own spread);
    the merged LoRA weights within one bf16 rounding of W + scale (alpha / r)
    up @ down computed in fp32 on the CPU. The load's seconds and the file's
    bytes."""
    import shutil
    import tempfile

    import torch

    from mdu_tpu_torch.models.loader import load_safetensors
    from mdu_tpu_torch.models.lora import merge_lora
    from mdu_tpu_torch.models.safetensors import save_file
    from mdu_tpu_torch.models.single_file import load_single_file
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    pipe, cond, uncond, sp, td, tv = build_config2()
    tmp = tempfile.mkdtemp(dir=ROOT, prefix="_load_smoke_")
    try:
        torch.cuda.synchronize()
        path, nbytes, write_s, tc = _write_checkpoint(pipe, tmp)
        lora_path = os.path.join(tmp, "lora.safetensors")
        save_file(_kohya_lora(pipe.unet.state_dict(), LOAD_LORA_NAMES, 8,
                              torch.Generator().manual_seed(6)), lora_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lpipe, lcond = load_single_file(path, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        lora = load_safetensors(lora_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(lpipe.device.type == "cuda", "the loaded pipeline is not on the card")
    n_tensors = 0
    for src, dst in ((pipe.unet, lpipe.unet), (pipe.vae, lpipe.vae), (tc.model, lcond.model)):
        a, b = src.state_dict(), dst.state_dict()
        require(set(a) == set(b), "load: the loaded modules' entries differ")
        for k in a:
            require(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]),
                    f"load: {k} differs from its source")
        n_tensors += len(a)
    require(type(lcond.tokenizer).__name__ == "CLIPTokenizer"
            and lcond.tokenizer.tokenize("a cat") == tc.tokenizer.tokenize("a cat"),
            "load: the tokenizer folder beside the file was not read")

    def image(p, seed=0):
        res = p.txt2img(cond, uncond, width=CFG2["width"], height=CFG2["height"], sampler=sp,
                        seed=seed, tiled_diffusion=td, tiled_vae=tv)
        torch.cuda.synchronize()
        return res

    reset_launches()
    a = image(pipe)
    launches = dict(LAUNCHES)
    require(launches.get("flash_attention_fm", 0) == 200 and launches.get("flash_attention") == 1,
            f"load: launches of the in-memory image {launches}")
    a2 = image(pipe)
    t0 = time.perf_counter()
    reset_launches()
    b = image(lpipe)
    loaded_s = time.perf_counter() - t0
    require(dict(LAUNCHES) == launches, f"load: the loaded pipeline launched {dict(LAUNCHES)}")
    spread = (a.latents - a2.latents).abs().max().item()
    diff = (a.latents - b.latents).abs().max().item()
    img_diff = int(abs(a.images.astype(int) - b.images.astype(int)).max())
    require(diff <= spread and (spread > 0 or img_diff == 0),
            f"load: the loaded pipeline's image differs by {diff} (runs of one pipeline: "
            f"{spread})")

    scale = 0.8
    merged = merge_lora(lpipe.unet.state_dict(), lora, scale)
    worst = 0.0
    for name in LOAD_LORA_NAMES:
        ref = _lora_reference(lpipe.unet.state_dict()[name], lora, name, scale)
        got = merged[name].float().cpu()
        require(merged[name].dtype == torch.bfloat16, f"load: merged {name} not bf16")
        # one bf16 rounding of the result: 2^-7 of its magnitude
        bound = ref.abs() * 2.0 ** -7 + 1e-30
        excess = ((got - ref).abs() / bound).max().item()
        require(excess <= 1.0, f"load: merged {name} off the fp32 reference by {excess} "
                               "bf16 roundings")
        worst = max(worst, excess)
    emit("load", config="config 2's SD1.5 (bf16) + a random CLIP-L as one LDM single file",
         file_bytes=nbytes, tensors=n_tensors, write_s=write_s, load_s=load_s,
         bit_equal=True, loaded_image_s=loaded_s, latent_max_abs_diff=diff,
         same_pipeline_spread=spread, image_max_abs_diff=img_diff, launches=launches,
         lora_rank=8, lora_scale=scale, lora_weights=LOAD_LORA_NAMES,
         lora_worst_in_bf16_roundings=worst)
    del pipe, lpipe, tc, lcond
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- the CLI

CLI_PROMPT = ("a lighthouse on a cliff at dusk, (dramatic sky:1.2)", "blurry, low quality")
# config 2's settings as the CLI takes them (bench.py's config 2)
CLI_TXT2IMG = ["-W", "2048", "-H", "512", "--steps", "20", "--cfg-scale", "7", "--sampler",
               "Euler", "--tile-width", "96", "--tile-height", "96", "--overlap", "48",
               "--tile-batch-size", "8", "--no-fast-decoder", "--vae-decoder-tile", "128",
               "--bf16", "--seed", "7"]
# config 3's settings (bench.py:345-377) as the CLI takes them
CLI_IMG2IMG = ["--upscaler", "Lanczos", "--scale-factor", "4", "--method", "Mixture of Diffusers",
               "--tile-width", "96", "--tile-height", "96", "--overlap", "8",
               "--tile-batch-size", "8", "--noise-inverse", "--noise-inverse-steps", "10",
               "--noise-inverse-renoise-strength", "1", "--denoising-strength", "0.4",
               "--steps", "20", "--cfg-scale", "7", "--no-fast-encoder", "--no-fast-decoder",
               "--vae-encoder-tile", "1024", "--vae-decoder-tile", "64", "--bf16", "--seed", "0"]
CLI_STOP_AFTER = 10           # the interrupted run: the flag set after step 10


def _write_checkpoint(pipe, tmp, clip_seed=3):
    """Config 2's SD1.5 (``pipe``'s weights) and a random CLIP-L as one LDM
    single file in ``tmp``, a char-level ``tokenizer/`` folder beside it.
    Returns (path, bytes, the write's seconds, the CLIP's conditioner)."""
    import torch

    from mdu_tpu_torch.models.clip import clip_l_config
    from mdu_tpu_torch.models.safetensors import save_file
    from mdu_tpu_torch.models.single_file import ldm_state_dict

    tc = _conditioner(clip_l_config(), clip_seed, torch.bfloat16, torch.device("cuda"))
    path = os.path.join(tmp, "sd15.safetensors")
    t0 = time.perf_counter()
    save_file(ldm_state_dict(pipe.unet, pipe.vae, tc.model), path)
    write_s = time.perf_counter() - t0
    os.makedirs(os.path.join(tmp, "tokenizer"))
    vocab, _ = synth_vocab(49408)
    with open(os.path.join(tmp, "tokenizer", "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(tmp, "tokenizer", "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    return path, os.path.getsize(path), write_s, tc


def _run_cli_subprocess(argv, timeout=600):
    """``python -m mdu_tpu_torch.cli *argv`` from the checkout, its standard
    error read line by line with the time each line arrived. Returns
    (seconds, [(t, line), ...]); fails on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "mdu_tpu_torch.cli", *argv], cwd=str(ROOT),
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    lines = []
    try:
        for line in proc.stderr:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli subprocess exited {proc.returncode}: "
            + " | ".join(l for _, l in lines[-5:]))
    return seconds, lines


def phase_cli():
    """Config 2 through the command line, as a user runs it: config 2's
    weights (random bf16) and a random CLIP-L written as one single file into
    ``_cli_smoke_*/`` in the checkout (deleted afterwards), with a char-level
    tokenizer beside it. ``python -m mdu_tpu_torch.cli txt2img`` at config
    2's settings in a subprocess: its seconds to start, to load and to make
    the image, and its ``perfcount`` line (peak device memory). Its PNG,
    read back by the port's reader: 2048 x 512, the ``parameters`` infotext,
    which ``cli.main(["info", ...])`` prints. In this process, the same file
    loaded and the same image made with ``pipe.txt2img`` (the conds from
    ``conditioner.pair``, seed 7) twice: the CLI's pixels within the card's
    own spread (the two in-process images' difference), #1 200 and #2 1 an
    image. Then an image interrupted by its step callback after step 10: #1
    100, finite, ``"Interrupted": true`` in its infotext. Then
    ``cli.main(["img2img", ...])`` at config 3's settings on a 512 x 512 PNG
    the phase writes, on the pipeline loaded above (``cli._load`` returns
    it): #1 570, #2 2, a 2048 x 2048 PNG."""
    import argparse
    import io
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from mdu_tpu_torch import cli
    from mdu_tpu_torch.models.single_file import load_single_file
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.utils.image import read_png, save_png

    pipe, *_ = build_config2()
    tmp = tempfile.mkdtemp(dir=ROOT, prefix="_cli_smoke_")
    saved_sigint = signal.getsignal(signal.SIGINT)
    try:
        path, nbytes, write_s, _ = _write_checkpoint(pipe, tmp)
        del pipe
        torch.cuda.empty_cache()
        out_png = os.path.join(tmp, "out.png")
        argv = (["txt2img", "--model-dir", path, "--prompt", CLI_PROMPT[0], "--negative",
                 CLI_PROMPT[1], "--out", out_png] + CLI_TXT2IMG)
        total_s, lines = _run_cli_subprocess(argv)
        t_load = next(t for t, l in lines if l.startswith("loading checkpoint"))
        perf = [(t, l) for t, l in lines if l.startswith("[Tiled Diffusion]: Done in")]
        require(len(perf) == 1, f"cli: no perfcount line in {[l for _, l in lines]}")
        t_done, perf_line = perf[0]
        image_s = float(perf_line.split("Done in ")[1].split("s")[0])
        require("peak device" in perf_line, f"cli: no peak memory in {perf_line!r}")
        png = read_png(out_png)
        require(png.size == (2048, 512) and png.mode == "RGB",
                f"cli: PNG of {png.size} {png.mode}")
        info = json.loads(png.text["parameters"])
        want = {"Prompt": CLI_PROMPT[0], "Negative prompt": CLI_PROMPT[1], "Sampler": "Euler",
                "Steps": 20, "CFG scale": 7.0, "Seed": 7}
        require(all(info.get(k) == v for k, v in want.items())
                and info["Tiled Diffusion"]["Tile tile width"] == 96
                and info["Tiled Diffusion"]["Tile Overlap"] == 48,
                f"cli: infotext {info}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["info", out_png])
        require(buf.getvalue() == json.dumps(info, indent=2) + "\n", "cli: info printed "
                + buf.getvalue()[:200])
        signal.signal(signal.SIGINT, saved_sigint)

        # the same image in this process
        args = cli.build_parser().parse_args(argv)
        td, tv, sp, _ = cli._configs(args)
        t0 = time.perf_counter()
        lpipe, lcond = load_single_file(path, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cond, uncond = lcond.pair(CLI_PROMPT[0], CLI_PROMPT[1], sp.steps)

        def image(**kw):
            res = lpipe.txt2img(cond, uncond, 2048, 512, sp, 7, tiled_diffusion=td,
                                tiled_vae=tv, **kw)
            torch.cuda.synchronize()
            return res

        reset_launches()
        a = image()
        launches = dict(LAUNCHES)
        want_l = {k: EXPECTED_LAUNCHES.get(k, 0) for k in launches}
        require(launches == want_l, f"cli: in-process launches {launches}, expected {want_l}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = image()
        inproc_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        spread = int(np.abs(a.images.astype(int) - b.images.astype(int)).max())
        pix = png.convert("RGB").astype(int)
        diff = int(np.abs(pix - a.images[0].astype(int)).max())
        mean_diff = float(np.abs(pix - a.images[0].astype(int)).mean())
        require(diff <= spread, f"cli: the CLI's pixels differ from the in-process image by "
                                f"{diff} levels (two in-process images: {spread})")

        # interrupted by the step callback after step 10
        def stop(i, x):
            if i == CLI_STOP_AFTER - 1:
                lpipe.interrupted = True

        reset_launches()
        try:
            r = image(step_callback=stop)
        finally:
            interrupted = lpipe.interrupted
            lpipe.interrupted = False
        int_launches = dict(LAUNCHES)
        want_i = {"flash_attention_fm": 10 * CLI_STOP_AFTER,
                  "flash_attention_fm.sm90": 10 * CLI_STOP_AFTER,
                  "flash_attention": 1, "flash_attention.wide": 1}
        want_i = {k: want_i.get(k, 0) for k in int_launches}
        require(int_launches == want_i, f"cli interrupted: launches {int_launches}, "
                                        f"expected {want_i}")
        require(bool(torch.isfinite(r.latents).all()), "cli interrupted: non-finite latents")
        info_i = cli._with_prompt(argparse.Namespace(prompt=CLI_PROMPT[0],
                                                     negative=CLI_PROMPT[1],
                                                     _pipe=argparse.Namespace(
                                                         interrupted=interrupted)), r.info)
        require(info_i.get("Interrupted") is True, f"cli interrupted: infotext {info_i}")
        del a, b, r

        # img2img through cli.main at config 3's settings, on the pipeline
        # loaded above from the same file (the CLI's loader, not run twice)
        init = os.path.join(tmp, "init.png")
        yy, xx = np.mgrid[0:512, 0:512]
        save_png(init, np.stack([(yy // 2) % 256, (xx // 2) % 256, ((yy + xx) // 4) % 256],
                                -1).astype(np.uint8))
        out_i2i = os.path.join(tmp, "i2i.png")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        err = io.StringIO()
        load = cli._load
        cli._load = lambda args: (lpipe, lcond)
        try:
            with contextlib.redirect_stderr(err):
                cli.main(["img2img", "--model-dir", path, "--init", init, "--prompt",
                          CLI_PROMPT[0], "--negative", CLI_PROMPT[1], "--out", out_i2i]
                         + CLI_IMG2IMG)
        finally:
            cli._load = load
        torch.cuda.synchronize()
        i2i_s = time.perf_counter() - t0
        i2i_peak = torch.cuda.max_memory_allocated()
        i2i_launches = dict(LAUNCHES)
        want_3 = {k: EXPECTED_CONFIG3.get(k, 0) for k in i2i_launches}
        require(i2i_launches == want_3, f"cli img2img: launches {i2i_launches}, expected {want_3}")
        i2i = read_png(out_i2i)
        require(i2i.size == (2048, 2048), f"cli img2img: PNG of {i2i.size}")
        i2i_perf = [l for l in err.getvalue().splitlines() if l.startswith("[Tiled Diffusion]")]
        del lpipe, lcond
        torch.cuda.empty_cache()
    finally:
        signal.signal(signal.SIGINT, saved_sigint)
        shutil.rmtree(tmp, ignore_errors=True)
    emit("cli", config="config 2 through `python -m mdu_tpu_torch.cli txt2img` (SD1.5 bf16 + "
                       "random CLIP-L as one single file)",
         file_bytes=nbytes, write_s=write_s, subprocess_s=total_s, startup_s=t_load,
         load_and_image_s=t_done - t_load, image_s=image_s, load_s=t_done - t_load - image_s,
         perfcount=perf_line, infotext=info, inprocess_load_s=load_s,
         inprocess_seconds_per_image=inproc_s, inprocess_img_per_min=60.0 / inproc_s,
         inprocess_peak_bytes=peak, pixel_max_abs_diff=diff, pixel_mean_abs_diff=mean_diff,
         same_pipeline_pixel_spread=spread, launches=launches,
         interrupted_after=CLI_STOP_AFTER, interrupted_launches=int_launches,
         img2img_s=i2i_s, img2img_peak_bytes=i2i_peak, img2img_launches=i2i_launches,
         img2img_perfcount=i2i_perf)
    return {"txt2img": launches, "interrupted": int_launches, "img2img": i2i_launches}


# ----------------------------------------------------------------- the layouts

# config 2 under MDU_UNET_LAYOUT=NHWC with the four flags: #6 takes every
# ResBlock conv the JAX planner fits, 36 a UNet call (NCHW's 16 and 20 above
# 640 channels: 1280 -> 1280 at 16 x 24 and 8 x 12, 640 -> 1280, 1280 -> 640
# and 960 -> 640 at 32 x 48); #4 never (JAX's NHWC GroupNorm is the plain one)
EXPECTED_NHWC_FLAGGED = {"flash_attention_t": 200, "flash_attention_t.sm90": 200,
                         "flash_attention": 1, "flash_attention.wide": 1,
                         "fused_conv3x3": 720, "fused_conv3x3.sm90": 720,
                         "fused_tile_blend": 20}
LAYOUT_RUNS = (("NHWC", {"MDU_UNET_LAYOUT": "NHWC"}, EXPECTED_LAUNCHES),
               ("NHWC flagged", {"MDU_UNET_LAYOUT": "NHWC", **FLAGS}, EXPECTED_NHWC_FLAGGED),
               ("MDU_GN=fold", {"MDU_GN": "fold"}, EXPECTED_LAUNCHES),
               ("MDU_GN=chanreduce", {"MDU_GN": "chanreduce"}, EXPECTED_LAUNCHES),
               ("MDU_CONV_MM=9mm", {"MDU_CONV_MM": "9mm"}, EXPECTED_LAUNCHES),
               ("MDU_CONV_MM=im2col", {"MDU_CONV_MM": "im2col"}, EXPECTED_LAUNCHES))


def phase_layouts():
    """Config 2 (bf16, random weights) under each of ``LAYOUT_RUNS`` against
    the default: 1 warm and 1 timed image each (the warm one alone for the
    settings in ``WARM_ONLY``), launches pinned (forms included), img/min
    and peak memory. The NHWC pipeline's UNet is built
    under ``MDU_UNET_LAYOUT=NHWC`` as the loaders build it, on the default
    UNet's weights. Each setting's seed-0 latents against the default's
    within 3 e + 1e-3 x max, e the default's own bf16 error (its max abs
    difference from the fp32 latents of the same weights): the two are bf16
    roundings of one fp32 computation, so their difference is at most the
    sum of their errors, and a reordering may double its own."""
    import torch

    from mdu_tpu_torch import DiffusionPipeline
    from mdu_tpu_torch.models import UNet2DCondition, default_unet_layout, sd15_unet_config
    from mdu_tpu_torch.ops.conv_mm import mm_route

    pipe, cond, uncond, sp, td, tv = build_config2()
    with torch.device("meta"):
        u32 = UNet2DCondition(sd15_unet_config(), dtype=torch.float32)
    u32.load_state_dict({k: v.float() for k, v in pipe.unet.state_dict().items()}, assign=True)
    p32 = DiffusionPipeline(u32, pipe.vae)
    t0 = time.perf_counter()
    ref32 = p32.txt2img(cond, uncond, width=CFG2["width"], height=CFG2["height"], sampler=sp,
                        seed=0, tiled_diffusion=td, tiled_vae=tv, decode=False).latents.float()
    torch.cuda.synchronize()
    ref32_s = time.perf_counter() - t0
    del p32, u32
    torch.cuda.empty_cache()
    kept = []
    launches, base = run_config2(pipe, cond, uncond, sp, td, tv, EXPECTED_LAUNCHES, "default",
                                 n=1, keep=kept)
    default = kept.pop().latents.float()
    own = (default - ref32).abs().max().item()
    scale = ref32.abs().max().item()
    bar = 3.0 * own + 1e-3 * scale
    emit("layouts", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16", run="default",
         flags={}, bf16_error_vs_fp32=own, fp32_reference_s=ref32_s, **base)
    out = {"default": launches}
    nhwc = None
    for label, flags, expected in LAYOUT_RUNS:
        with flags_set(flags):
            run_pipe = pipe
            if "MDU_UNET_LAYOUT" in flags:
                if nhwc is None:
                    layout = default_unet_layout()
                    with torch.device("meta"):
                        unet = UNet2DCondition(sd15_unet_config(), dtype=torch.bfloat16,
                                               layout=layout)
                    unet.load_state_dict(pipe.unet.state_dict(), assign=True)
                    nhwc = DiffusionPipeline(unet, pipe.vae)
                    require(nhwc.unet.layout == "NHWC", "layouts: the UNet is not channels-last")
                run_pipe = nhwc
            got_l, fields = run_config2(run_pipe, cond, uncond, sp, td, tv, expected, label,
                                        n=0 if ("layouts", label) in WARM_ONLY else 1,
                                        keep=kept)
            lat = kept.pop().latents.float()
        diff = (lat - default).abs().max().item()
        require(diff <= bar, f"layouts {label}: latents differ from the default's by {diff} > "
                             f"{bar} (3 x the bf16 error {own} + 1e-3 x {scale})")
        extra = {"mm_route": mm_route("cuda", torch.bfloat16)} if "MDU_CONV_MM" in flags else {}
        emit("layouts", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16",
             run=label, flags=flags, latent_max_abs_diff=diff,
             latent_mean_abs_diff=(lat - default).abs().mean().item(), bar=bar,
             expected_launches=expected, default_img_per_min=base["img_per_min"], **extra,
             **fields)
        out[label] = got_l
    del pipe, nhwc
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ this slice's tiny paths

# a narrow UNet whose level 1 is wider than 640 channels: under NHWC the fused
# conv takes 768 -> 768 and 1536 -> 768 there (NCHW stops at 640)
WIDE_TINY_UNET = dict(block_out_channels=(64, 768), layers_per_block=1, cross_attention_dim=16,
                      num_heads=8, transformer_layers=(0, 0), norm_num_groups=32)


@contextlib.contextmanager
def _tiny_factories():
    """The config factories the single-file loader calls, pointed at the tiny
    configs for a ``with`` block (the CLI has no config flags)."""
    from mdu_tpu_torch.models import clip as clip_mod
    from mdu_tpu_torch.models import unet as unet_mod
    from mdu_tpu_torch.models import vae as vae_mod

    tu, tv, tc = unet_mod.tiny_unet_config(), vae_mod.tiny_vae_config(), clip_mod.tiny_clip_config()
    saved = [(unet_mod, "sd15_unet_config"), (vae_mod, "VAEConfig"), (clip_mod, "clip_l_config")]
    old = [getattr(m, n) for m, n in saved]
    unet_mod.sd15_unet_config = lambda: tu
    vae_mod.VAEConfig = lambda **kw: tv
    clip_mod.clip_l_config = lambda: tc
    try:
        yield tu, tv, tc
    finally:
        for (m, n), f in zip(saved, old):
            setattr(m, n, f)


@contextlib.contextmanager
def _cpu_drawn_noise():
    """``DiffusionPipeline.txt2img`` drawing its starting noise from a CPU
    generator seeded with the seed for a ``with`` block, so that a card run
    gets the CPU run's draws (a CUDA generator draws other numbers)."""
    import torch

    from mdu_tpu_torch.pipeline import DiffusionPipeline

    orig = DiffusionPipeline.txt2img

    def txt2img(self, cond, uncond, width=512, height=512, sampler=None, seed=0,
                tiled_diffusion=None, tiled_vae=None, region_conds=(), **kw):
        noise = torch.randn((1, self.unet.cfg.out_channels, height // 8, width // 8),
                            generator=torch.Generator().manual_seed(seed))
        return self._txt2img_from_noise(noise, cond, uncond, sampler, seed, tiled_diffusion,
                                        tiled_vae, region_conds=region_conds, **kw)

    DiffusionPipeline.txt2img = txt2img
    try:
        yield
    finally:
        DiffusionPipeline.txt2img = orig


def _tiny_cli(tmp):
    """The tiny pipeline and the tiny CLIP (random fp32 weights drawn on the
    CPU) as one single file (no tokenizer beside it: the loader's hash
    tokenizer, of the tiny CLIP's length), and the CLI's txt2img on it, on
    the card and on the CPU, its noise drawn on the CPU for both: (png on
    cuda, png on cpu)."""
    import signal

    import torch

    from mdu_tpu_torch import cli
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, random_state_dict,
                                      tiny_unet_config, tiny_vae_config)
    from mdu_tpu_torch.models.clip import CLIPTextModel, tiny_clip_config
    from mdu_tpu_torch.models.safetensors import save_file
    from mdu_tpu_torch.models.single_file import ldm_state_dict

    unet = UNet2DCondition(tiny_unet_config())
    unet.load_state_dict(random_state_dict(unet, 0, device="cpu"))
    vae = AutoencoderKL(tiny_vae_config())
    vae.load_state_dict(random_state_dict(vae, 1, device="cpu"))
    clip = CLIPTextModel(tiny_clip_config())
    clip.load_state_dict(_clip_weights(clip, 3, torch.float32, "cpu"))
    path = os.path.join(tmp, "tiny.safetensors")
    save_file(ldm_state_dict(unet, vae, clip), path)
    saved = signal.getsignal(signal.SIGINT)
    outs = {}
    try:
        with _tiny_factories(), _cpu_drawn_noise():
            for dev in ("cuda", "cpu"):
                outs[dev] = os.path.join(tmp, f"{dev}.png")
                cli.main(["txt2img", "--model-dir", path, "--prompt", "a (red:1.3) cat",
                          "--negative", "dog", "-W", "512", "-H", "256", "--steps", "3",
                          "--tile-width", "32", "--tile-height", "32", "--overlap", "16",
                          "--tile-batch-size", "3", "--no-fast-decoder",
                          "--vae-decoder-tile", "32", "--seed", "3", "--device", dev,
                          "--out", outs[dev]])
    finally:
        signal.signal(signal.SIGINT, saved)
    return outs["cuda"], outs["cpu"]


def _wide_unet(device, dtype, fused_shapes=None):
    """``WIDE_TINY_UNET`` (random weights drawn on the CPU) built under
    ``MDU_UNET_LAYOUT=NHWC`` and run under ``MDU_FUSED_CONV=1`` on a [2, 4,
    16, 16] latent; ``fused_shapes`` collects the (C, Co) of every conv that
    takes the fused path. Returns the output on the CPU in fp32."""
    import torch

    from mdu_tpu_torch.models import UNet2DCondition, UNetConfig, random_state_dict
    from mdu_tpu_torch.models.layers import Conv2D
    from mdu_tpu_torch.models.unet import default_unet_layout

    with flags_set({"MDU_UNET_LAYOUT": "NHWC", "MDU_FUSED_CONV": "1"}):
        unet = UNet2DCondition(UNetConfig(**WIDE_TINY_UNET), dtype=dtype,
                               layout=default_unet_layout())
        unet.load_state_dict(random_state_dict(unet, 5, dtype, device="cpu"))
        unet = unet.to(device).to(memory_format=torch.channels_last).eval()
        if fused_shapes is not None:
            def hook(m, args, kwargs):
                if kwargs.get("scale") is not None and m._fused_ok(args[0]):
                    fused_shapes.append(tuple(m.weight.shape[:2][::-1]))
            for m in unet.modules():
                if isinstance(m, Conv2D):
                    m.register_forward_pre_hook(hook, with_kwargs=True)
        gen = torch.Generator().manual_seed(6)
        x = torch.randn(2, 4, 16, 16, generator=gen)
        ctx = torch.randn(2, 7, 16, generator=gen)
        with torch.no_grad():
            y = unet(x.to(device), torch.tensor([20.0, 600.0], device=device),
                     ctx.to(device, dtype))
    return y.float().cpu()


def phase_reference_cli():
    """This slice's tiny paths on the card against the CPU: the CLI's tiny
    txt2img (fp32, the PNGs within 1 uint8 level: fp32's 1e-4 of the
    largest value, rounded, the infotexts equal; #1 launched); the wide tiny
    UNet under NHWC with #6 on (fp32 and bf16 at the usual bars; every conv
    the fused path takes launches #6, some of them wider than 640 channels);
    ``conv3x3_mm`` in both modes and layouts, fp32 and bf16, at the usual
    bars, with the route of its bf16 products on the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mdu_tpu_torch.ops.conv_mm import conv3x3_mm, mm_route
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.utils.image import read_png

    tmp = tempfile.mkdtemp(dir=ROOT, prefix="_cli_smoke_")
    try:
        reset_launches()
        card, cpu = _tiny_cli(tmp)
        launches = dict(LAUNCHES)
        a, b = read_png(card), read_png(cpu)
        diff = int(np.abs(a.pixels.astype(int) - b.pixels.astype(int)).max())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(launches.get("flash_attention_fm_f32", 0) > 0, f"tiny CLI: launches {launches}")
    require(a.size == b.size == (512, 256) and diff <= 1,
            f"tiny CLI: card and CPU PNGs differ by {diff} levels")
    require(a.text == b.text, "tiny CLI: the infotexts differ")
    emit("reference", dtype="float32", pipeline="tiny CLI txt2img", flags={},
         launches=launches, pixel_max_abs_diff=diff, tol=1)

    ref = _wide_unet("cpu", torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        own = None if dtype == torch.float32 else {
            "out": (_wide_unet("cpu", dtype) - ref).abs().max().item()}
        shapes = []
        reset_launches()
        got = _wide_unet("cuda", dtype, shapes)
        launches = dict(LAUNCHES)
        key = "fused_conv3x3" if dtype == torch.bfloat16 else "fused_conv3x3_f32"
        require(launches.get(key, 0) == len(shapes) > 0
                and any(max(s) > 640 for s in shapes),
                f"wide tiny UNet {dtype}: {key} {launches.get(key, 0)}, fused convs {shapes}")
        fields = _hold_parts("wide tiny UNet NHWC", {"out": got}, {"out": ref}, own, dtype)
        emit("reference", dtype=_dtype_name(dtype), pipeline="wide tiny UNet, NHWC",
             flags={"MDU_UNET_LAYOUT": "NHWC", "MDU_FUSED_CONV": "1"}, launches=launches,
             fused_shapes=sorted(set(shapes)), **fields)

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 320, 32, 48, generator=gen)
    w = torch.randn(640, 320, 3, 3, generator=gen) / (9 * 320) ** 0.5
    for mode in ("9mm", "im2col"):
        for layout in ("NCHW", "NHWC"):
            xl = x if layout == "NCHW" else x.permute(0, 2, 3, 1).contiguous()
            ref = conv3x3_mm(xl, w, mode, layout)
            for dtype in (torch.float32, torch.bfloat16):
                own = None if dtype == torch.float32 else {"out": (conv3x3_mm(
                    xl.to(dtype), w.to(dtype), mode, layout).float() - ref).abs().max().item()}
                got = conv3x3_mm(xl.to("cuda", dtype), w.to("cuda", dtype), mode, layout)
                fields = _hold_parts(f"conv3x3_mm {mode} {layout}", {"out": got.float().cpu()},
                                     {"out": ref}, own, dtype)
                emit("reference", dtype=_dtype_name(dtype), pipeline=f"conv3x3_mm {mode} {layout}",
                     flags={}, shape=[2, 320, 32, 48, 640],
                     route=mm_route("cuda", dtype), **fields)


def phase_stream8k():
    """The 2K -> 8K's exact decode: a [1, 4, 1024, 1024] latent at decoder
    tile 64 (256 tiles of 86, groups of up to 8) through
    ``DiffusionPipeline._decode_tensor`` in the mode the pipeline picks with
    no ``MDU_HBM_BYTES`` (the card's free memory): the mode, the footprints
    against free memory, seconds, peak device memory and the host's peak
    RSS; the output [1, 3, 8192, 8192] and finite."""
    import resource

    import torch

    from mdu_tpu_torch import TiledVAEConfig
    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mdu_tpu_torch.tiling.tiled_vae import (DECODER_PAD, lockstep_footprint_bytes,
                                                plan_vae_tiles, streaming_device_footprint_bytes)

    pipe, *_ = build_config2()
    dev = torch.device("cuda")
    z = torch.randn(1, 4, 1024, 1024, generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    tv = TiledVAEConfig(decoder_tile_size=64, fast_decoder=False, tile_batch=8)
    plan = plan_vae_tiles(1024, 1024, 64, DECODER_PAD)
    free = torch.cuda.mem_get_info(dev)[0]
    mode = pipe._exact_vae_mode("decoder", 64, 1024, 1024, 1, tv.tile_batch)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    img = pipe._decode_tensor(z, tv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require(pipe.last_vae_mode == mode, f"stream8k: ran {pipe.last_vae_mode}, picked {mode}")
    require(tuple(img.shape) == (1, 3, 8192, 8192) and bool(torch.isfinite(img).all()),
            f"stream8k: output {tuple(img.shape)} or non-finite")
    emit("stream8k", config="the 2K -> 8K's exact decode, SD VAE bf16", mode=mode,
         tiles=plan.num_tiles, tile_batch=tv.tile_batch, free_bytes=free,
         lockstep_footprint_bytes=lockstep_footprint_bytes("decoder", 64, plan.num_tiles, 1),
         stream_device_footprint_bytes=streaming_device_footprint_bytes(
             "decoder", 64, plan.num_tiles, 1, tv.tile_batch),
         seconds=seconds, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         host_peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
         launches=launches, output_shape=list(img.shape), finite=True)
    del pipe, z, img
    torch.cuda.empty_cache()
    return launches


def kernel_rows(checks, launches, config3=None, upscale8k=None, config4=None, config5=None,
                slice_runs=None, train=None):
    """The ``{"kernels": [...]}`` rows: every kernel at its main (first)
    config-2 shape, with its launches per image in the config-2 run that
    takes it (the flagged run for the flagged kernels, the fp32 image for the
    fp32 kernels), and beside them its launches per config-3 and per
    config-4 image (the flagged or the default run, as for config 2), in
    the 8K upscale and per config-5 image (the x3 image with no flag, the x2
    one under the four flags), and in this slice's runs (``slice_runs``: the
    streaming VAE's modes, config 2 from prompts, the loaded checkpoint's
    image, the 8K exact decode) where they launch it. A kernel with forms
    also lists the forms checked, the
    launches of each form in that run, and every config-2 shape with the
    earlier form's time (attention with the MUFU floor, fp32 with the FMA
    bound and, for attention, SDPA under both backends); #1's wide form has
    its own row (launches from the MDU_FLASH=fm run)."""
    rows = []
    c2_fields = ("shape", "form", "fuse_act", "ms", "device_ms", "earlier_form", "earlier_ms",
                 "earlier_device_ms", "bound_ms", "fma_bound_ms", "mufu_floor_ms",
                 "library_ms", "library_device_ms", "library_backend", "library_efficient_ms",
                 "library_efficient_device_ms", "plain_ms", "max_abs_err",
                 "earlier_max_abs_err", "cluster", "dtype", "other_form", "other_device_ms",
                 "other_max_abs_err")
    conv_c2 = KERNELS["fused_conv3x3"]["shapes"][:4]
    # kernel -> (config-2 run that takes it, its config-2 shapes)
    where = {"flash_attention_fm": ("default", KERNELS["flash_attention_fm"]["shapes"][:2]),
             "flash_attention": ("default", [(2, 1, 9600, 512)]),
             "flash_attention_t": ("flagged", KERNELS["flash_attention_t"]["shapes"][:2]),
             "fused_group_norm": ("flagged", KERNELS["fused_group_norm"]["shapes"][:6]),
             "fused_tile_blend": ("flagged", []),
             "fused_conv3x3": ("flagged", conv_c2),
             "flash_attention_fm_f32": ("fp32 conv", F32_CONFIG2[:2]),
             "flash_attention_f32": ("fp32 conv", F32_CONFIG2[2:]),
             "fused_conv3x3_f32": ("fp32 conv", conv_c2)}
    templates = {"flash_attention_fm": "mdu_tpu_torch/csrc/flash_attention_sm90.cuh",
                 "flash_attention_t": "mdu_tpu_torch/csrc/flash_attention_sm90.cuh",
                 "flash_attention": "mdu_tpu_torch/csrc/flash_attention_wide_sm90.cuh"}

    def row(name, key, checked, run, c2, source, launch_key=None, **extra):
        main = checked[0]
        got = launches.get(run, {})
        counted = launch_key or key
        if config3 is not None:
            extra["config3_launches"] = config3.get(
                "flagged" if run == "flagged" else "default", {}).get(counted, 0)
        if config4 is not None:
            extra["config4_launches"] = config4.get(
                "flagged" if run == "flagged" else "default", {}).get(counted, 0)
        if upscale8k is not None:
            extra["upscale8k_launches"] = upscale8k.get(counted, 0)
        if config5 is not None:
            extra["config5_launches"] = config5.get(
                "flagged" if run == "flagged" else "default", {}).get(counted, 0)
        for phase, runs in (slice_runs or {}).items():
            seen = {label: got_l.get(counted, 0) for label, got_l in runs.items()
                    if got_l.get(counted, 0)}
            if seen:
                extra[f"{phase}_launches"] = seen
        forms = sorted({c["form"] for c in checked if c.get("form")})
        if forms:
            extra.update(forms=forms,
                         form_launches={k.split(".", 1)[1]: v for k, v in got.items()
                                        if k.startswith(key + ".")})
        c2_checks = [c for c in checked if tuple(c["shape"]) in c2 and c.get("fuse_act", True)
                     and c["dtype"] == main["dtype"]]
        if c2_checks:
            extra["config2_shapes"] = [{f: c.get(f) for f in c2_fields if f in c}
                                       for c in c2_checks]
        return dict(name=name, route="cuda", source=source,
                    replaces=KERNELS[F32_KERNELS[key][0] if key in F32_KERNELS else key]
                    ["replaces"], launches=got.get(launch_key or key, 0), launches_run=run,
                    max_abs_err=max(c["max_abs_err"] for c in checked),
                    ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], library_device_ms=main["library_device_ms"],
                    shape=main["shape"], dtype=main["dtype"],
                    **{f: main[f] for f in ("form", "earlier_form", "earlier_ms",
                                            "earlier_device_ms", "fma_bound_ms",
                                            "mufu_floor_ms", "bound_basis", "library_backend",
                                            "library_efficient_ms", "floor_ms",
                                            "floor_device_ms") if f in main},
                    **extra)

    for name in list(KERNELS) + list(F32_KERNELS):
        if name not in checks:
            continue
        run, c2 = where[name]
        source = F32_KERNELS[name][1] if name in F32_KERNELS else KERNELS[name]["source"]
        extra = {"template": templates[name]} if name in templates else {}
        if name + "_sharp" in checks:
            extra["sharp_softmax"] = [{f: c.get(f) for f in ("shape", "form", "qscale",
                                                             "max_abs_err", "tol", "ms",
                                                             "device_ms")}
                                      for c in checks[name + "_sharp"]]
        rows.append(row(name, name, checks[name], run, c2, source, **extra))
        wide = [c for c in checks[name] if c.get("form") == "wide"]
        if wide and name == "flash_attention_fm":
            rows.append(row(name + ".wide", name, wide, "fm", [(2, 1, 9600, 512)],
                            "mdu_tpu_torch/csrc/flash_attention_wide_sm90.cuh",
                            launch_key=name + ".wide", entry="mdu_flash_attention_fm_wide"))
    if "flash_attention_bwd" in checks:
        # the backward of #1-#3 (no TPU kernel has one), named by the form its
        # main shape (the train step's level 0 in fp32) takes; each form's
        # launches per train step, and each dtype's tensor-core form with its
        # CUDA-core form's earlier time at the train step's shapes
        bwd = checks["flash_attention_bwd"]
        main = bwd[0]
        per_step = {k: v for k, v in (train or {}).get("dp 1 x tp 1", {}).items()
                    if k.startswith("flash_attention_bwd.")}
        fields = ("shape", "dtype", "form", "max_abs_err", "tol", "ms", "device_ms",
                  "earlier_form", "earlier_ms", "earlier_device_ms", "earlier_max_abs_err",
                  "plain_ms", "library_ms", "library_device_ms", "library_backend",
                  "bound_ms", "bound_by", "fma_bound_ms")
        forms = []
        for form, source in (("f32_sm90", "mdu_tpu_torch/csrc/flash_attention_bwd_f32.cu"),
                             ("bf16_sm90", "mdu_tpu_torch/csrc/flash_attention_bwd_bf16.cu")):
            taken = [c for c in bwd if c["form"] == form]
            forms.append(dict(
                form=form, source=source, design="mdu_tpu_torch/csrc/flash_attention_bwd_sm90.cuh",
                launches_per_train_step=per_step.get(f"flash_attention_bwd.{form}", 0),
                earlier_form=form.split("_")[0] + "_simt",
                earlier_source="mdu_tpu_torch/csrc/flash_attention_bwd.cu",
                shapes=[{f: c.get(f) for f in fields if f in c} for c in taken]))
        rows.append(dict(
            name="flash_attention_bwd", route="cuda", form=main["form"],
            source="mdu_tpu_torch/csrc/flash_attention_bwd_sm90.cuh",
            replaces="mdu_tpu/ops/pallas/flash_attention.py:215",
            replaces_note="the gradient of flash_attention_t_fm (and of :335, :282); the "
                          "Pallas kernels have none",
            launches=(train or {}).get("dp 1 x tp 1", {}).get("flash_attention_bwd", 0),
            launches_run="train, dp 1 x tp 1, per step",
            train_launches={k: v.get("flash_attention_bwd", 0) for k, v in (train or {}).items()},
            form_launches_per_train_step=per_step,
            max_abs_err=max(c["max_abs_err"] for c in bwd), ms=main["ms"],
            device_ms=main["device_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], fma_bound_ms=main.get("fma_bound_ms"),
            library_ms=main["library_ms"], library_device_ms=main["library_device_ms"],
            library="torch.autograd.grad of F.scaled_dot_product_attention",
            shape=main["shape"], dtype=main["dtype"],
            **{f: main[f] for f in ("earlier_form", "earlier_ms", "earlier_device_ms")
               if f in main},
            forms=forms))
    return rows


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,reference,txt2img,samplers,deepcache,mesh,unclip,prompts,"
                            "load,cli,layouts,img2img,adapters,stream,regional,upscale8k,"
                            "train,demofusion",
                    help="comma-separated phases after device and build (stream8k and "
                         "reference_cli, a part of reference, run only when named)")
    phases = set(ap.parse_args().phases.split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "mdu_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no mdu_tpu_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for flag in FLAGS:                   # each run below sets the flags it wants
        os.environ.pop(flag, None)

    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    from mdu_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: v["path"].rsplit("/", 1)[-1] for k, v in report.items()},
         ptxas={k: v["ptxas"] for k, v in report.items()})

    checks, launches = {}, {}
    phase_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            phase_s[name] = time.perf_counter() - t0

    with _cpu_pool() if "reference" in phases else contextlib.nullcontext() as pool:
        if pool is not None:
            # the reference phases' CPU runs start now, on the pool's workers
            # beside the kernel checks, which leave the host's other cores idle
            ref_get = _submit_refs(pool, _reference_runs()[2])
            adapters_get = _submit_refs(pool, [(spec, {}) for _, spec, _, _ in _adapter_runs()])
        if "kernels" in phases:
            checks = timed("kernels", phase_kernels)
            emit("kernels", kernels={k: [dict(shape=c["shape"], dtype=c["dtype"],
                                              max_abs_err=c["max_abs_err"], tol=c["tol"])
                                         for c in v] for k, v in checks.items()})
        if pool is not None:
            timed("reference", lambda: phase_reference(ref_get))
            timed("reference_slice", phase_reference_slice)
            timed("reference_adapters", lambda: phase_reference_adapters(adapters_get))
    if "reference" in phases or "reference_cli" in phases:
        timed("reference_cli", phase_reference_cli)
    if "txt2img" in phases:
        launches = timed("txt2img", phase_txt2img)
    if "samplers" in phases:
        timed("samplers", phase_samplers)
    slice_runs = {}
    if "deepcache" in phases:
        slice_runs["deepcache"] = timed("deepcache", phase_deepcache)
    if "mesh" in phases:
        slice_runs["mesh"] = timed("mesh", phase_mesh)
    if "unclip" in phases:
        slice_runs["unclip"] = {"unclip": timed("unclip", phase_unclip)}
    if "prompts" in phases:
        slice_runs["prompts"] = timed("prompts", phase_prompts)
    if "load" in phases:
        slice_runs["load"] = {"loaded": timed("load", phase_load)}
    if "cli" in phases:
        slice_runs["cli"] = timed("cli", phase_cli)
    if "layouts" in phases:
        slice_runs["layouts"] = timed("layouts", phase_layouts)
    config3 = timed("img2img", phase_img2img) if "img2img" in phases else None
    if "adapters" in phases:
        slice_runs["adapters"] = timed("adapters", phase_adapters)
    if "stream" in phases:
        slice_runs["stream"] = timed("stream", phase_stream)
    config4 = timed("regional", phase_regional) if "regional" in phases else None
    up8k = timed("upscale8k", phase_upscale8k) if "upscale8k" in phases else None
    if "stream8k" in phases:
        slice_runs["stream8k"] = {"decode": timed("stream8k", phase_stream8k)}
    train = timed("train", phase_train) if "train" in phases else None
    config5 = timed("demofusion", phase_demofusion) if "demofusion" in phases else None
    if config5 is not None:
        slice_runs["demofusion_deepcache"] = {"x2": config5.pop("deepcache x2")}

    emit("done", seconds=time.perf_counter() - t_start, phases=sorted(phases),
         phase_seconds=phase_s)
    print(json.dumps({"kernels": kernel_rows(checks, launches, config3, up8k, config4,
                                             config5, slice_runs, train)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
