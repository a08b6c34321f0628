#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernels against
their plain versions.

Run from the root of a checkout, with one CUDA device: ``python3 chip_smoke.py``.
It imports only PyTorch and the port (``comfyui_parallelanything_tpu_torch``),
never JAX. Each phase prints one JSON line; any failure raises and exits non-zero,
and without a CUDA device (or without the port beside it) nothing is printed but
the error.

1. device — the card, and ``nvidia-smi``'s name and power limit line.
2. build — every CUDA kernel under ``csrc/``, one ``nvcc`` per translation unit, in
   parallel (the seconds to each unit's end are printed).
3. kernel — K1 (flash attention) against its plain version at every ``KERNEL_CASES``
   row (the FLUX-dev shape, contiguous and with the single block's strided v, a
   ragged Sq≠Sk shape, head dims 64, 40 and 256, f16, f32, an unaligned view, more
   than 65535 batch·heads, the FLUX VAE's 512-wide head at 1024², ragged cases at
   head dims 160, 264, 320 and 512, f16, f32, a single query and key and more than
   65535 batch·heads at D=512, unaligned views at D=160 and 512, every self- and
   cross-attention call of the SDXL and SD1.5 UNets at their real shapes, SD3.5's
   joint (4250 = 4096 image + 154 text tokens) and x-only attention at 1024², and in
   float32 ragged cases at head dims 40, 80, 160 and 256, SD1.5's calls, more than
   65535 batch·heads, an unaligned view and D=512), each through the variant the
   wrapper's ``kernel_variant`` picks, which must be the row's; within limits set
   from the kernel's measured error. Two planted tail bugs (the last key block's
   padding left unmasked, the last key dropped) must fail the same check at D=128
   (bf16 and f32) and D=512. A probe measures ``ex2.approx``'s and ``exp2f``'s error
   and checks that the tensor cores truncate a raw f32 word read as TF32. Each
   variant is then timed (``TIMED``) beside its plain version,
   ``F.scaled_dot_product_attention`` (timed here only, never called by the port;
   the backend it took is recorded) and the card's bound: ``sm90`` and ``mma`` at
   the FLUX-dev shape, ``wide`` and ``d512`` (forced) at the VAE shape, ``tf32x3``
   and ``f32`` (forced) at the FLUX-dev shape in float32 against three passes at the
   card's TF32 rate and its f32 rate; then (2, 4096, 8, 160) through ``wide`` and
   ``mma`` forced and ``f32`` once at the VAE shape in float32
   (``THROUGHPUT_TIMED``), the UNets' and SD3.5-large's shapes (``SHAPES_TIMED``), and
   the device time
   per call through the rule's variant, a forced one and SDPA at SD1.5's 160-wide
   bf16 shapes (``mma`` forced) and at all its float32 shapes (``f32`` forced) from
   a profiler window (``DEVICE_TIMED``).
4. main_path — FLUX-dev at full width and depth (19 double + 38 single blocks,
   3072 wide, 24×128 heads) in bf16 with random weights from a seeded generator
   on the card, wrapped by ``parallelize`` over ``[("cuda:0", 100)]``, sampled by
   ``flow_euler_sample`` at 1024² (latent 128×128×16, 512 text tokens,
   guidance 3.5) for 4 steps: K1's ``sm90`` variant must serve every attention call
   (57 per step) and the latent must be finite. One forward is then held against
   the same model on the plain attention path, one step runs at batch 2, and one
   step runs under ``torch.profiler``: the top 10 CUDA kernels by total time, K1's
   share and the device's busy share. After the pipeline phase the same 4 steps
   run with ``compile_loop=True`` (the whole loop captured as one CUDA graph,
   ``sampling/compiled.py``) and eager, in turns (``captured_turns``): s/it, the
   capture's seconds, peak memory, the captured latent against the eager one, and
   exactly 57 ``sm90`` a forward per replay.
5. pipeline — ``FluxPipeline`` from a prompt to a 1024² image: the main path's
   FLUX-dev with CLIP-L, T5-XXL (512 tokens) and the FLUX VAE at full width, random
   weights from a seeded generator, a tokenizer built here over a synthetic vocab;
   4 steps, guidance 3.5, then an img2img call (denoise 0.5, 2 steps) on its
   image. Times encode, denoise and decode; K1 must serve the DiT (``sm90``) and
   the VAE's mid-block attention (``wide``, once per encode or decode); the image
   must be finite, (1, 1024, 1024, 3) and in [0, 1]; a decode through K1 must
   agree with the same decode on the plain attention path. The FLUX models are
   freed after it.
6. sd_pipeline — ``StableDiffusionPipeline`` with SDXL-base at full width
   (``sdxl_config()``, 2.57 B parameters), CLIP-L, OpenCLIP-G and the SDXL VAE,
   random bf16 weights from a seeded generator, the UNet wrapped by ``parallelize``
   over ``[("cuda:0", 100)]``: 1024², batch 1, 8 steps of ``dpmpp_2m``/karras, CFG
   7.0 with a negative prompt. Times encode, s/it and decode, reads the peak
   memory; K1 must serve exactly 140 ``sm90`` calls per step (70 transformer
   blocks × self + cross, cond ‖ uncond in one batch-2 call) and one ``wide``
   call for the decode; the image must be finite, (1, 1024, 1024, 3), in [0, 1].
   One UNet forward is held against the same forward on plain attention, and one
   step runs under ``torch.profiler``. Then the pipeline with ``compile_loop=True``
   against the eager pipeline in turns (s/it from the denoise, s/image, peak
   memory; 140 ``sm90`` a forward per replay), and one captured denoise under the
   profiler.
7. sd_samplers — SD1.5 at full width (``sd15_config()``) at 512², CFG 7.0,
   through ``parallelize`` → ``run_sampler`` with every sampler name but
   ``flow_euler`` (2 steps, 3 for the multistep ones), then an img2img (denoise
   0.5) and an inpaint call: every latent finite, and K1 launches exactly 20
   ``sm90`` + 10 ``wide`` per UNet forward (head dims 40 and 80, and 160; no middle
   transformer, as the JAX package's ``middle_depth`` gives ``sd15_config()``
   none). Then ``dpmpp_2m`` at 10 steps for its s/it, one UNet forward held
   against the same forward on plain attention and one profiled step. Every call
   then runs again captured, each within 1e-3 relative L2 of its eager run with the
   same generator, and ``dpmpp_2m`` over 10 steps captured against eager in turns,
   then profiled captured; every captured run must take no ``compile-eager`` rung.
   capture_fallback — the same SD1.5 through a model that reads a device value on
   the host while a CUDA graph captures (``compile_loop=True``, dpmpp_2m, 4 steps):
   exactly one ``compile-eager`` rung and one ``degradation`` span, the latent
   bitwise the eager loop's, K1's launches the eager loop's plus the warm-up forward
   that preceded the broken capture, no loop left cached, no memory left allocated.
   hybrid — the same SD1.5 UNet on ``[("cuda:0", 75), ("cpu", 25)]`` at 512², batch
   4, CFG 7, 2 euler steps with ``compile_loop=True``, which must run eager: the
   weights blended from the H100's and the host's roofline specs, each 8-row
   forward's split, the host group's seconds a step, every sample within 5e-2 of
   the card alone, and 20 ``sm90`` + 10 ``wide`` per GPU forward only.
8. sd15_f32 — the same SD1.5 in float32 (what ``--force-fp32`` gives a user), TF32
   off for matmuls and convolutions: one batch-2 UNet forward through K1 held
   against the same forward on plain attention, then ``dpmpp_2m`` for a few steps
   (s/it, peak memory); K1 launches exactly 30 ``tf32x3`` and no ``f32`` per
   forward (head dims 40, 80 and 160, 10 calls each).
9. sd15_controlnet — the SD1.5 UNet with a ControlNet of the same config (random
   zero convolutions: zero ones make it a no-op) at 512² through ``apply_control``
   → ``parallelize`` → ``run_sampler`` dpmpp_2m/karras, 10 steps, CFG 7.0: exactly
   28 ``sm90`` + 14 ``wide`` per forward (the base's 20 + 10, the ControlNet
   trunk's 8 + 4); one composed forward held against plain attention, the residuals
   at strength 0.5 exactly half those at 1.0; then a 9-channel inpaint UNet through
   ``apply_inpaint_conditioning``, one forward with 20 ``sm90`` + 10 ``wide``, held
   against plain attention.
10. sd3 — ``Sd3Pipeline`` with SD3.5-large at full width and depth (38 blocks,
   hidden 2432, 38 heads of 64, q/k RMS norm; 8.15 B parameters, the adaLN and final
   linears in f32), CLIP-L, OpenCLIP-G, T5-XXL padded to 77 tokens (a 154-token
   context) and the SD3 VAE, random weights from a seeded generator, the MMDiT
   through ``parallelize``: 1024², batch 1, 8 steps of flow_euler at shift 3, CFG
   4.5 with a negative prompt (cond ‖ uncond in one batch-2 forward): exactly 38
   ``sm90`` a step and one ``wide`` for the decode, the image finite,
   (1, 1024, 1024, 3), in [0, 1]; a batch-2 forward held against plain attention,
   one step under ``torch.profiler``; the 8-step denoise captured against eager in
   turns, 38 ``sm90`` a forward per replay, its peak memory below the card's; then
   SD3.5-medium (mmdit-x) at full size, one
   batch-2 forward with exactly 37 ``sm90`` (24 joint + 13 x-only attentions), held
   against plain attention.
11. pipeline_placement — after the main path's captured run, the same FLUX-dev on
   ``[("cuda:0", 97), ("cpu", 3)]`` with the default ``ParallelConfig``: the
   blended weights give the host the last single block, so batch-1 sampling places
   the blocks as a pipeline; 4 steps (one when the first passes 30 s) with exactly
   56 ``sm90`` a step, the latent within 5e-2 of the card alone, the host stage's
   and every hop's seconds, the seconds to place the stages and peak memory; then
   a batch-2 step with ``pipeline_microbatches=2`` (2 × 56 ``sm90``); with more
   than one card, batch 1 over every card (57 ``sm90``, within 1e-3 of one card),
   else a ``skipped`` line.
   stream — the same FLUX-dev moved to the host and streamed through
   ``parallel/streaming.py`` on ``[("cuda:0", 100)]`` under
   ``ParallelConfig(hbm_budget_bytes=8 GiB)`` (the weights-don't-fit route): the
   carve, the pinned bytes against the streamed ones and the host's resident memory,
   a pinned 1 GiB host→device copy's rate; bf16 at batch 1 (4 steps, against the
   main path's latent and s/it and the copy bound), one profiled step (the stage
   copies and the kernels beside them), one serialised step, batch 4 (2 steps,
   against a resident batch-4 run), and int8 (2 steps, against a resident int8 run):
   peak device memory within the budget at batch 1 and int8, the streamed weights'
   device peak (the run's peak less the rest of the card, the resident submodules
   and the resident run's activations) and the tracker's peak within two stages,
   exactly 57 ``sm90`` a forward, every latent bitwise its
   resident run's (or within 1e-3). ``stream_traced``: one step with the span tracer
   on in a ``torch.profiler`` window: one ``stream-run`` and a prefetch and a compute
   span a stage, each within max(10 %, 0.5 ms) of the profiler's copy and of the
   extent of the kernels launched in that stage, the overlap efficiency within 0.05
   of the profiler's, the latent bitwise the untraced step's.
12. checkpoint — after FLUX-dev is freed: a FLUX-dev state dict in the public BFL
   layout made on the card (fp8 block weights) with a rank-16 kohya LoRA over every
   block's qkv, proj, MLP, linear1 and linear2, through ``load_flux_checkpoint`` →
   ``parallelize`` → 4 steps: the bake's and the load's seconds, peak memory, s/it,
   exactly 57 ``sm90`` a step, a forward against plain attention, and the baked
   latent within 2e-2 of ``run_sampler(..., lora=factors)`` on the unbaked model.
13. graph — the port's graph host (``host.run_workflow`` on ``cuda:0``) at full
   width, on files written to a temp directory from seeded generators (SD1.5 with its
   bundled VAE in the ldm layout, CLIP-L in the HF layout, each held by a round trip
   through the port's converters; CLIP tables over the synthetic vocab; an ESRGAN x4
   in RealESRGAN_x4plus's layout), with the port's safetensors writer. First
   K1 at the new shapes the graphs give it (SD1.5 at 1024², the VAE at batch 8),
   checked and timed. Then ``workflow_sd15_txt2img`` (512², batch 8, 28 dpmpp_2m
   steps, CFG 7.5), ``workflow_sd15_hiresfix`` (20 steps at 512², 2× latent
   upscale, 14 steps at 1024², decode, ESRGAN ×4 in 256 tiles to 4096²) and the
   txt2img graph with ``quantize="int8"`` at 4 steps, each with only its paths, its
   chain (one ``cuda:0`` link) and its save node changed: seconds per node, s/it,
   peak memory and exactly 20 ``sm90`` + 10 ``wide`` per UNet forward plus one
   ``wide`` per decode; the txt2img latent against a direct ``run_sampler``, the int8
   run's weight bytes and latent against bf16's.
14. graph_stock — the stock-name shims (``nodes_compat.py``) on the same files, the
   checkpoint rewritten with its CLIP-L bundled as
   ``$PA_MODELS_DIR/checkpoints/v1-5-pruned-emaonly.safetensors`` and the tokenizer
   tables given through ``PA_CLIP_VOCAB`` + ``PA_CLIP_MERGES``:
   ``workflow_stock_sd15_txt2img`` as shipped but its ``SaveImage`` (1024², batch 4,
   20 dpmpp_2m/karras steps, CFG 7, ``FreeU_V2``): exactly 400 ``sm90`` + 201 ``wide``,
   the latent against a direct ``run_sampler`` with the graph's FreeU model, the
   device memory the ``FreeU_V2`` node adds under 1 % of the UNet's bytes; then
   ``workflow_sd15_inpaint_outpaint`` (the ``graph`` phase's rewrite, its ``source``
   pre-seeded with a seeded 512² image, no save): a finite (1, 512, 640, 3) paste equal
   to the padded source wherever the pad mask is 0, exactly 400 ``sm90`` + 202
   ``wide`` (the VAE encode's and decode's mid-block calls). Their new K1 shapes are
   in ``GRAPH_K1_SHAPES``, checked one batch element at a time where the plain
   version's logits would not fit.
15. wan — ``WanVideoPipeline`` with Wan2.1-T2V-1.3B at full width and depth (30
   blocks, hidden 1536, 12 heads of 128), UMT5-XXL at 512 tokens and the Wan VAE,
   random bf16 weights from a seeded generator, the DiT through ``parallelize`` on
   ``[("cuda:0", 100)]``: 480×832, 81 frames (a 21×60×104 latent, 32760 space-time
   tokens), 4 flow_euler steps at shift 5, CFG 5 with a negative prompt (one batch-2
   forward): exactly 60 ``sm90`` a forward and one ``wide`` for the decode; the video
   finite, (1, 81, 480, 832, 3), in [0, 1]; encode, denoise and decode seconds, s/it,
   peak memory; a DiT forward and a whole-clip decode against plain attention; one
   profiled step; 2 steps captured against eager in turns, bitwise, 60 ``sm90`` a
   forward per replay.
16. wan_i2v — the same pipeline image→video with Wan2.1-I2V-14B-480P (40 blocks,
   hidden 5120, 40 heads, 36 input channels, the CLIP branch over 257 tokens of 1280)
   and the port's CLIP ViT-H/14 tower on a seeded start image, the t2v phase's UMT5
   and VAE (the 81-frame conditioning clip encoded whole): 2 steps, CFG 5, exactly 120
   ``sm90`` a forward, one ``wide`` in the encode and one in the decode; then one
   forward at 17 frames against plain attention. The 14B model is freed after it.
   The kernel phase holds K1 at both phases' calls (``wan_*`` rows of
   ``KERNEL_CASES``), the self-attention rows one (batch, head) pair at a time.
17. serving — the port's server (``server.py``) in this process on the graph phase's
   SD1.5 files: K1 at the lanes' shapes (``SERVING_K1_SHAPES``), then 8
   ``workflow_sd15_txt2img`` prompts at 512² (batch 1, euler / dpmpp_2m /
   euler_ancestral / heun, 20 or 28 steps, two texts, save node kept) through 1
   worker (inline) and 4 workers (the continuous-batching scheduler and the decode
   tail): dispatches, lane occupancy, images/s, latency p50/p95, s per dispatch
   against the inline s/it, peak memory, exactly 20 ``sm90`` + 10 ``wide`` per
   dispatch and one ``wide`` per decode dispatch; the images through ``/history``
   and ``/view``; each lane against its inline run and its run alone in a width-4
   bucket; then the same 8 lanes in float32 through the scheduler directly, bitwise
   their runs alone and within 1e-3 of inline. Traced (``serving_traced``): the 8
   prompts through a server started with ``trace=True``: each prompt's timeline from
   ``GET /trace?prompt_id=`` (``prompt`` → ``workflow-node`` → ``sampler-run`` →
   ``lane-wait``/``lane``/``step``, ``decode``, nested), as many ``serving-dispatch``
   spans as ``pa_serving_dispatch_total`` grew, the SLO stages' p50/p95 (the
   exposition's and the spans'), each request's ``lane_wait`` ≤ ``eval``,
   ``decode_wait`` ≤ ``decode`` and stages within its residency, what the stages
   leave uncovered; then (``serving_traced_profile``) 12 width-4 dispatches of 4
   euler lanes in a ``hardware_trace`` window: each span within max(5 %, 0.5 ms) of
   its profiler range, the kernels launched in it ending inside it, the device busy
   share (union of its kernels over it, and over the median unprofiled dispatch, since
   CPU activity tracing stretches the window); the synchronise calls of the same
   dispatches with tracing off equal; the median dispatch seconds off and on in
   turns; and (``serving_row_bisect``) the first UNet module whose output row
   depends on the row's place, with cuDNN's default and deterministic algorithms.
   ``serving_flux`` (after
   ``main_path_captured``, while FLUX-dev is alive): K1 at (4, 4608, 24, 128), four
   flow lanes of 4 / 4 / 3 / 2 steps through a width-4 scheduler, 57 ``sm90`` a
   dispatch, each lane within 5e-2 of its inline run.
``hybrid`` also prints ``hybrid_rows``: the GPU group's rows of one CFG forward
against the same rows of the 8-row forward on the card alone.
Then the script's wall time, the ``kernels`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, same data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor cores, same data sheet
TF32X3_PASSES = 3  # tf32x3 takes every product as three TF32 products
H100_HBM_BYTES_S = 3.35e12

STEPS = 4
FLUX_SHAPE = (1, 4608, 24, 128)  # 4096 image + 512 text tokens at 1024²
VAE_SHAPE = (1, 16384, 1, 512)  # the FLUX VAE's mid-block attention at 1024² (128² latent)
SDXL_4096 = (2, 4096, 10, 64)  # SDXL at 1024², latent level 1 (64²), 640 wide
SDXL_1024 = (2, 1024, 20, 64)  # SDXL at 1024², latent level 2 (32²), 1280 wide
SD15_4096 = (2, 4096, 8, 40)  # SD1.5 at 512², latent level 0 (64²), 320 wide
SD15_1024 = (2, 1024, 8, 80)  # level 1 (32²), 640 wide
SD15_256 = (2, 256, 8, 160)  # level 2 (16²), 1280 wide
SD35L_JOINT = (2, 4250, 38, 64)  # SD3.5-large at 1024²: 154 text + 4096 image tokens
SD35M_JOINT = (2, 4250, 24, 64)  # SD3.5-medium's joint attention, the same tokens
SD35M_X = (2, 4096, 24, 64)  # SD3.5-medium's x-only attention (its first 13 blocks)
# Wan at 480×832, 81 frames: a 21×60×104 latent, 2×2 patches → 32760 space-time tokens
# (255·128 + 120, a ragged tail), CFG's batch 2; text cross-attention over 512 UMT5
# tokens and the 14B i2v image cross-attention over 257 CLIP tokens (2·128 + 1).
WAN13_SELF = (2, 32760, 12, 128)  # Wan2.1-T2V-1.3B: 12 heads of 128
WAN14_SELF = (2, 32760, 40, 128)  # Wan2.1-I2V-14B: 40 heads of 128
WAN_VAE_MID = (21, 6240, 1, 384)  # the Wan VAE's mid-block: 21 frames of 60×104, C = 384
# name, q shape, k/v shape, dtype name, layout, the variant that must serve it.
# Layouts: "contiguous"; "single_block_v", v a strided view of a fused projection
# as in the FLUX single block (q and k contiguous); "unaligned", every input a
# view one element into its storage (2-byte aligned); "fused_qkv", q, k and v views
# of one (B, S, H, 3·D) projection, as the Wan VAE's mid-block splits its to_qkv.
KERNEL_CASES = [
    ("flux_dev_1024", FLUX_SHAPE, FLUX_SHAPE, "bfloat16", "contiguous", "sm90"),
    ("flux_dev_1024_single_block_v", FLUX_SHAPE, FLUX_SHAPE, "bfloat16", "single_block_v",
     "sm90"),
    ("ragged_300x513", (2, 300, 4, 128), (2, 513, 4, 128), "bfloat16", "contiguous", "sm90"),
    ("d64", (2, 300, 4, 64), (2, 513, 4, 64), "bfloat16", "contiguous", "sm90"),
    ("d40", (2, 300, 4, 40), (2, 513, 4, 40), "bfloat16", "contiguous", "sm90"),
    ("f16", (2, 300, 4, 128), (2, 513, 4, 128), "float16", "contiguous", "sm90"),
    ("f32", (2, 300, 4, 128), (2, 513, 4, 128), "float32", "contiguous", "tf32x3"),
    ("d256", (2, 300, 4, 256), (2, 513, 4, 256), "bfloat16", "contiguous", "wide"),
    ("unaligned", (2, 300, 4, 128), (2, 513, 4, 128), "bfloat16", "unaligned", "mma"),
    ("batch_heads_65600", (65600, 3, 1, 8), (65600, 3, 1, 8), "bfloat16", "contiguous", "sm90"),
    ("vae_1024_d512", VAE_SHAPE, VAE_SHAPE, "bfloat16", "contiguous", "wide"),
    ("d512_ragged_300x513", (2, 300, 2, 512), (2, 513, 2, 512), "bfloat16", "contiguous", "wide"),
    ("d264", (2, 300, 2, 264), (2, 513, 2, 264), "bfloat16", "contiguous", "wide"),
    ("d320", (2, 300, 2, 320), (2, 513, 2, 320), "bfloat16", "contiguous", "wide"),
    ("d512_f16", (2, 300, 2, 512), (2, 513, 2, 512), "float16", "contiguous", "wide"),
    ("d512_single", (1, 1, 1, 512), (1, 1, 1, 512), "bfloat16", "contiguous", "wide"),
    ("d512_batch_heads_65537", (65537, 2, 1, 512), (65537, 3, 1, 512), "bfloat16",
     "contiguous", "wide"),
    ("d512_f32", (1, 300, 2, 512), (1, 513, 2, 512), "float32", "contiguous", "f32"),
    ("vae_1024_d512_f32", VAE_SHAPE, VAE_SHAPE, "float32", "contiguous", "f32"),
    # float32 through tf32x3: one tile (its hi parts are the raw words, which a card
    # that rounded them would fail here by about 1e-4), the UNets' head dims and its
    # widest, and past 65535 batch·heads; an unaligned view keeps the scalar kernel.
    ("f32_one_tile", (1, 64, 1, 128), (1, 64, 1, 128), "float32", "contiguous", "tf32x3"),
    ("f32_d40", (2, 300, 4, 40), (2, 513, 4, 40), "float32", "contiguous", "tf32x3"),
    ("f32_d80", (2, 300, 4, 80), (2, 513, 4, 80), "float32", "contiguous", "tf32x3"),
    ("f32_d160", (2, 300, 4, 160), (2, 513, 4, 160), "float32", "contiguous", "tf32x3"),
    ("f32_d256", (2, 300, 2, 256), (2, 513, 2, 256), "float32", "contiguous", "tf32x3"),
    ("f32_batch_heads_65600", (65600, 3, 1, 8), (65600, 3, 1, 8), "float32", "contiguous",
     "tf32x3"),
    ("f32_unaligned", (2, 300, 4, 128), (2, 513, 4, 128), "float32", "unaligned", "f32"),
    # What TMA cannot take keeps the mma.sync variants: unaligned views.
    ("d160_unaligned", (2, 300, 4, 160), (2, 513, 4, 160), "bfloat16", "unaligned", "mma"),
    ("d512_unaligned", (2, 300, 2, 512), (2, 513, 2, 512), "bfloat16", "unaligned", "d512"),
    # The SD-family UNets' calls at their real shapes (CFG's batch 2): SDXL at
    # 1024² (head dim 64), SD1.5 at 512² (head dims 40, 80, 160), self-attention
    # and cross-attention over 77 text tokens; then ragged cases at D=80 and 160.
    ("sdxl_self_4096_d64", SDXL_4096, SDXL_4096, "bfloat16", "contiguous", "sm90"),
    ("sdxl_self_1024_d64", SDXL_1024, SDXL_1024, "bfloat16", "contiguous", "sm90"),
    ("sdxl_cross_4096x77_d64", SDXL_4096, (2, 77, 10, 64), "bfloat16", "contiguous", "sm90"),
    ("sdxl_cross_1024x77_d64", SDXL_1024, (2, 77, 20, 64), "bfloat16", "contiguous", "sm90"),
    ("sd15_self_4096_d40", SD15_4096, SD15_4096, "bfloat16", "contiguous", "sm90"),
    ("sd15_self_1024_d80", SD15_1024, SD15_1024, "bfloat16", "contiguous", "sm90"),
    ("sd15_self_256_d160", SD15_256, SD15_256, "bfloat16", "contiguous", "wide"),
    ("sd15_cross_4096x77_d40", SD15_4096, (2, 77, 8, 40), "bfloat16", "contiguous", "sm90"),
    ("sd15_cross_1024x77_d80", SD15_1024, (2, 77, 8, 80), "bfloat16", "contiguous", "sm90"),
    ("sd15_cross_256x77_d160", SD15_256, (2, 77, 8, 160), "bfloat16", "contiguous", "wide"),
    ("d80", (2, 300, 4, 80), (2, 513, 4, 80), "bfloat16", "contiguous", "sm90"),
    ("d160", (2, 300, 4, 160), (2, 513, 4, 160), "bfloat16", "contiguous", "wide"),
    # SD1.5's head dim at a long sequence, timed for throughput (no model call has it).
    ("d160_4096", (2, 4096, 8, 160), (2, 4096, 8, 160), "bfloat16", "contiguous", "wide"),
    # SD3's joint attention at 1024² (4096 image + 154 text tokens, a ragged 4250 =
    # 33·128 + 26) after the q/k RMS norm, CFG's batch 2: SD3.5-large's 38 heads and
    # SD3.5-medium's 24, and SD3.5-medium's x-only self-attention (mmdit-x).
    ("sd35_large_joint_4250_d64", SD35L_JOINT, SD35L_JOINT, "bfloat16", "contiguous", "sm90"),
    ("sd35_medium_joint_4250_d64", SD35M_JOINT, SD35M_JOINT, "bfloat16", "contiguous", "sm90"),
    ("sd35_medium_x_4096_d64", SD35M_X, SD35M_X, "bfloat16", "contiguous", "sm90"),
    # SD1.5's calls in float32 (``--force-fp32``), self and 77-key cross-attention.
    ("sd15_f32_self_4096_d40", SD15_4096, SD15_4096, "float32", "contiguous", "tf32x3"),
    ("sd15_f32_self_1024_d80", SD15_1024, SD15_1024, "float32", "contiguous", "tf32x3"),
    ("sd15_f32_self_256_d160", SD15_256, SD15_256, "float32", "contiguous", "tf32x3"),
    ("sd15_f32_cross_4096x77_d40", SD15_4096, (2, 77, 8, 40), "float32", "contiguous", "tf32x3"),
    ("sd15_f32_cross_1024x77_d80", SD15_1024, (2, 77, 8, 80), "float32", "contiguous", "tf32x3"),
    ("sd15_f32_cross_256x77_d160", SD15_256, (2, 77, 8, 160), "float32", "contiguous",
     "tf32x3"),
    # The hybrid phase's GPU group: SD1.5's calls at 7 of CFG's 8 rows (batch 4).
    ("sd15_hybrid_self_4096_d40", (7, 4096, 8, 40), (7, 4096, 8, 40), "bfloat16", "contiguous",
     "sm90"),
    ("sd15_hybrid_self_1024_d80", (7, 1024, 8, 80), (7, 1024, 8, 80), "bfloat16", "contiguous",
     "sm90"),
    ("sd15_hybrid_self_256_d160", (7, 256, 8, 160), (7, 256, 8, 160), "bfloat16", "contiguous",
     "wide"),
    ("sd15_hybrid_cross_4096x77_d40", (7, 4096, 8, 40), (7, 77, 8, 40), "bfloat16",
     "contiguous", "sm90"),
    ("sd15_hybrid_cross_1024x77_d80", (7, 1024, 8, 80), (7, 77, 8, 80), "bfloat16",
     "contiguous", "sm90"),
    ("sd15_hybrid_cross_256x77_d160", (7, 256, 8, 160), (7, 77, 8, 160), "bfloat16",
     "contiguous", "wide"),
    # Wan's calls at 480×832×81 (their plain checks run one batch element and head at a
    # time, ``kernel_error``): the 1.3B and 14B self- and text cross-attention, the
    # 14B i2v image cross-attention, and the video VAE's mid-block (wide, D = 384).
    ("wan_1_3b_self_32760", WAN13_SELF, WAN13_SELF, "bfloat16", "contiguous", "sm90"),
    ("wan_1_3b_cross_32760x512", WAN13_SELF, (2, 512, 12, 128), "bfloat16", "contiguous",
     "sm90"),
    ("wan_14b_self_32760", WAN14_SELF, WAN14_SELF, "bfloat16", "contiguous", "sm90"),
    ("wan_14b_cross_32760x512", WAN14_SELF, (2, 512, 40, 128), "bfloat16", "contiguous",
     "sm90"),
    ("wan_14b_img_32760x257", WAN14_SELF, (2, 257, 40, 128), "bfloat16", "contiguous",
     "sm90"),
    ("wan_vae_mid_d384", WAN_VAE_MID, WAN_VAE_MID, "bfloat16", "fused_qkv", "wide"),
]
# Limits on the kernel's error against the plain version computed in f32 on the
# same (exactly upcast) inputs: per element |got - want| <= atol + rtol · (P·|V|),
# and the relative L2 error over the whole output. P is rounded to the input type
# before P·V, and the output is rounded too: each costs at most half an ulp (2^-9
# relative in bf16, 2^-11 in f16) of P·|V|, which bounds |P·V|; rtol allows four.
# With randn inputs the outputs are about sqrt(e / Sk) in size (0.024 at the FLUX
# shape, 0.07 at Sk = 513), and the kernel's relative L2 error about 2e-3 in bf16.
# Leaving the 63 padded keys of a 513-key tail unmasked shrinks the output by about
# 7 %, and dropping the last key moves it by a few per cent: both must fail.
KERNEL_LIMITS = {  # dtype: (atol, rtol, relative L2)
    "bfloat16": (1e-4, 2**-7, 5e-3),
    "float16": (1e-5, 2**-9, 1e-3),
    # float32: the scalar kernel differs only in summation order; tf32x3 also drops
    # the lo·lo products and rounds the low parts to TF32 (about 2^-22 relative each).
    "float32": (1e-6, 1e-5, 1e-5),
}
MAIN_PATH_REL_TOL = 5e-2  # bf16 FLUX-dev forward, kernel vs plain attention


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_case(qshape, kshape, dtype_name, layout, gen, device):
    """q, k, v for one ``KERNEL_CASES`` row: standard normal values from ``gen``,
    laid out as ``layout`` says."""
    import torch

    dtype = getattr(torch, dtype_name)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    if layout == "contiguous":
        return randn(qshape), randn(kshape), randn(kshape)
    if layout == "single_block_v":
        b, s, h, d = kshape
        fused = randn((b, s, 7 * h * d))  # qkv (3·H·D) then the MLP input (4·H·D)
        v = fused[..., : 3 * h * d].reshape(b, s, 3, h, d)[:, :, 2]
        return randn(qshape), randn(kshape), v
    if layout == "unaligned":
        def shifted(shape):
            return randn((math.prod(shape) + 1,))[1:].view(shape)

        return shifted(qshape), shifted(kshape), shifted(kshape)
    if layout == "fused_qkv":
        if qshape != kshape:
            raise ValueError("fused_qkv is self-attention: q and k shapes must match")
        b, s, h, d = qshape
        return randn((b, s, h, 3 * d)).split(d, dim=-1)
    raise ValueError(f"unknown layout {layout!r}")


# Above this many bytes of f32 logits the plain version in ``kernel_error`` runs one
# (batch element, head) pair at a time: Wan's 32760-token self-attention makes
# 4.29 GB of logits per pair, 103 GB (1.3B) and 343 GB (14B) in all.
PLAIN_SLICE_BYTES = 20e9


def plain_logit_bytes(qshape, kshape) -> float:
    b, sq, h, _ = qshape
    return 4.0 * b * h * sq * kshape[1]


def kernel_error(got, q, k, v, scale=None) -> dict:
    """K1's output ``got`` for q/k/v against the plain version on the same inputs,
    upcast exactly to f32 and without the final cast: max abs and relative L2 error,
    and whether both are inside ``KERNEL_LIMITS`` for q's dtype. Where the plain
    version's logits pass ``PLAIN_SLICE_BYTES`` it runs per (batch element, head)
    pair (attention is independent per pair); the relative L2 error is then each
    batch element's over its heads, and the largest of those is returned."""
    from comfyui_parallelanything_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_plain,
    )

    atol, rtol, rel_l2_limit = KERNEL_LIMITS[str(q.dtype).removeprefix("torch.")]
    sliced = plain_logit_bytes(q.shape, k.shape) > PLAIN_SLICE_BYTES
    elements = ([slice(i, i + 1) for i in range(q.shape[0])] if sliced else [slice(None)])
    heads = ([slice(j, j + 1) for j in range(q.shape[2])] if sliced else [slice(None)])
    max_abs, rel_l2, ok = 0.0, 0.0, True
    for b in elements:
        diff_sq = want_sq = 0.0
        for h in heads:
            qf, kf, vf = (t[b, :, h].float() for t in (q, k, v))
            want = flash_attention_plain(qf, kf, vf, scale)
            mag = flash_attention_plain(qf, kf, vf.abs(), scale)  # P·|V|
            diff = (got[b, :, h].float() - want).abs()
            max_abs = max(max_abs, diff.max().item())
            diff_sq += diff.norm().item() ** 2
            want_sq += want.norm().item() ** 2
            ok = ok and bool((diff <= atol + rtol * mag).all().item())
            del want, mag, diff
        rel_l2 = max(rel_l2, math.sqrt(diff_sq / want_sq))
    res = {"max_abs_err": max_abs, "rel_l2_err": rel_l2, "ok": ok and rel_l2 <= rel_l2_limit}
    if sliced:
        res["checked_by_batch_element_head"] = len(elements) * len(heads)
    return res


def tail_bugs(q, k, v) -> dict:
    """Outputs of two wrong kernels, in q's dtype: the last 64-key block's padding
    left unmasked (logit 0 against zero values), and the last key dropped. The
    kernel check must reject both."""
    import torch.nn.functional as F

    from comfyui_parallelanything_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_plain,
    )

    qf, kf, vf = q.float(), k.float(), v.float()
    scale = q.shape[-1] ** -0.5
    pad = (0, 0, 0, 0, 0, -k.shape[1] % 64)
    return {
        "tail_unmasked": flash_attention_plain(qf, F.pad(kf, pad), F.pad(vf, pad), scale),
        "last_key_dropped": flash_attention_plain(qf, kf[:, :-1], vf[:, :-1], scale),
    }


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_bound_ms(qshape, kshape, elem_bytes: int, peak_flops: float) -> tuple[float, str]:
    """Least time for one attention call: operations (4·B·H·Sq·Sk·D) over the peak
    rate, or q/k/v/o bytes (each read or written once) over the memory rate."""
    b, sq, h, d = qshape
    sk = kshape[1]
    flops = 4.0 * b * h * sq * sk * d
    nbytes = elem_bytes * (2 * b * sq * h * d + 2 * b * sk * h * d)
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": card})


def phase_build():
    from comfyui_parallelanything_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    results = build.build_all()
    for name, r in results.items():
        print(f"--- nvcc {name}\n{r['log']}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"], "units": r["units"]}
                      for n, r in results.items()}})


def sdpa_backend(q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for (B, H, S, D) inputs."""
    import torch

    try:
        choice = torch._fused_sdp_choice(q, k, v)
        return torch.nn.attention.SDPBackend(choice).name
    except Exception as e:  # noqa: BLE001 - a private API; report, do not fail
        return f"unknown ({type(e).__name__})"


def peak_flops(variant: str) -> float:
    """The rate that bounds ``variant``'s operations: the f32 rate outside the tensor
    cores for ``f32``, three passes at the TF32 tensor-core rate for ``tf32x3``, the
    bf16/f16 rate for the others."""
    if variant == "f32":
        return H100_F32_FLOPS
    if variant == "tf32x3":
        return H100_TF32_FLOPS / TF32X3_PASSES
    return H100_BF16_FLOPS


def time_variant(fa, variant, q, k, v, iters, plain_iters, plain_batch=None,
                 plain_heads=None) -> dict:
    """One timing row: K1's ``variant`` forced on q/k/v, its plain version (on the
    first ``plain_batch`` batch elements and ``plain_heads`` heads when given: they
    are then in the row), ``F.scaled_dot_product_attention`` on the same inputs (and
    the backend it took), and the card's bound for the call."""
    import torch.nn.functional as F

    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pq, pk, pv = (t[:plain_batch or t.shape[0], :, :plain_heads or t.shape[2]]
                  for t in (q, k, v))
    bound_ms, bound_by = attention_bound_ms(tuple(q.shape), tuple(k.shape), q.element_size(),
                                            peak_flops(variant))
    return {
        "variant": variant, "shape": list(q.shape), "k_shape": list(k.shape),
        "dtype": str(q.dtype).removeprefix("torch."),
        "ms": time_ms(lambda: fa._launch(q, k, v, scale, variant), iters=iters),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(pq, pk, pv), iters=plain_iters,
                            warmup=1),
        **({"plain_batch": plain_batch} if plain_batch else {}),
        **({"plain_heads": plain_heads} if plain_heads else {}),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=iters),
        "library_backend": sdpa_backend(qt, kt, vt),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


# The cases whose inputs the kernel phase times, by variant: (case, dtype, iterations,
# iterations of the plain version). tf32x3 and f32 (forced) are timed at the FLUX-dev
# shape in float32; every bound is against ``peak_flops(variant)``.
TIMED = {"sm90": ("flux_dev_1024", "bfloat16", 20, 5),
         "mma": ("flux_dev_1024", "bfloat16", 20, 5),
         "wide": ("vae_1024_d512", "bfloat16", 20, 3),
         "d512": ("vae_1024_d512", "bfloat16", 10, 3),
         "tf32x3": ("flux_dev_1024", "float32", 10, 3),
         "f32": ("flux_dev_1024", "float32", 5, 3)}
# Cases timed through several variants, each forced: (variants, iterations,
# iterations of the plain version). The scalar f32 kernel is timed once at the VAE
# shape in float32 (an fp32 VAE's mid-block call, which tf32x3 does not take).
THROUGHPUT_TIMED = {"d160_4096": (("wide", "mma"), 20, 3),
                    "vae_1024_d512_f32": (("f32",), 1, 1)}
# Cases whose device time per call is read from a profiler window of back-to-back
# calls (one call is mostly host time there): K1 through the rule, a variant forced
# and SDPA, each called this many times in the window: (calls, forced variant).
DEVICE_TIMED = {"sd15_self_256_d160": (50, "mma"), "sd15_cross_256x77_d160": (50, "mma"),
                "sd15_f32_self_4096_d40": (20, "f32"), "sd15_f32_self_1024_d80": (20, "f32"),
                "sd15_f32_self_256_d160": (50, "f32"),
                "sd15_f32_cross_4096x77_d40": (20, "f32"),
                "sd15_f32_cross_1024x77_d80": (50, "f32"),
                "sd15_f32_cross_256x77_d160": (50, "f32")}
# Cases whose inputs must make the planted tail bugs fail the check.
TAIL_BUG_CASES = ("ragged_300x513", "f32", "d512_ragged_300x513")
# The SD-family shapes timed as the UNets call them, each through the variant the
# rule picks: (iterations, iterations of the plain version).
SHAPES_TIMED = {"sdxl_self_4096_d64": (30, 3), "sdxl_self_1024_d64": (50, 5),
                "sdxl_cross_4096x77_d64": (50, 5), "sdxl_cross_1024x77_d64": (50, 5),
                "sd15_self_4096_d40": (30, 3), "sd15_self_1024_d80": (50, 5),
                "sd15_self_256_d160": (50, 5), "sd15_f32_self_4096_d40": (20, 3),
                "sd15_f32_self_1024_d80": (50, 5), "sd15_f32_self_256_d160": (50, 5),
                "sd35_large_joint_4250_d64": (20, 2),
                # Wan's: the plain version of the self-attention rows is timed on one
                # batch element and head (``plain_batch``, ``plain_heads``).
                "wan_1_3b_self_32760": (10, 2), "wan_1_3b_cross_32760x512": (30, 3),
                "wan_14b_self_32760": (5, 2), "wan_14b_cross_32760x512": (20, 2),
                "wan_14b_img_32760x257": (20, 2), "wan_vae_mid_d384": (20, 2)}


def probe_numerics(dev) -> dict:
    """What tf32x3's numerics rest on, measured on the card (``pa_tf32x3_probe``):
    the largest relative error of ``ex2.approx.ftz`` (the kernel's exp2) and of
    ``exp2f`` against float64 over the softmax's arguments [-126, 0], and whether
    the tensor cores truncate or round a raw f32 word read as a TF32 operand (one
    ``mma.sync`` product w · 1 with w between two TF32 neighbours, nearer the upper),
    which tf32x3 relies on: it reads each raw word as its TF32 hi part."""
    import ctypes

    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import build

    fn = build.load("flash_attention").pa_tf32x3_probe
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    x = torch.linspace(-126.0, 0.0, 1 << 22, device=dev)
    fast, precise = torch.empty_like(x), torch.empty_like(x)
    w = 1.0 + 2.0**-11 + 2.0**-12  # TF32 neighbours: 1 and 1 + 2^-10
    words = torch.tensor([w, -w], device=dev)
    products = torch.empty_like(words)
    rc = fn(x.data_ptr(), fast.data_ptr(), precise.data_ptr(), x.numel(), words.data_ptr(),
            products.data_ptr(), words.numel(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"the tf32x3 probe failed to launch: CUDA error {rc}")
    want = torch.exp2(x.double())
    got = products.tolist()
    rounded = 1.0 + 2.0**-10
    return {
        "exp2_max_rel_err": {name: ((y.double() - want).abs() / want).max().item()
                             for name, y in (("ex2.approx.ftz", fast), ("exp2f", precise))},
        "tf32_operand": ("truncates" if got == [1.0, -1.0] else
                         "rounds" if got == [rounded, -rounded] else f"neither: {got}"),
    }


def loop_ms(fn, iters: int) -> float:
    """Device time per call over ``iters`` calls issued back to back, from two
    CUDA events around the whole run: where the host issues calls faster than the
    card runs them, the host's work per call is hidden, unlike in ``time_ms``."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fns: dict, calls: int) -> dict[str, float]:
    """Device time per call of each of ``fns`` (``{label: (fn, owns)}``): one
    ``torch.profiler`` window runs every ``fn`` ``calls`` times back to back, and a
    CUDA kernel counts for the label whose ``owns(kernel name)`` is true. Where one
    call is mostly the host's time, this is the card's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    # The tracer can miss the first kernels of a process's first window: a window in
    # which some label shows no kernel is measured again, twice at most.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn, _ in fns.values():
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        totals = kernel_times(prof)
        out = {label: sum(ms for name, (ms, _) in totals.items() if owns(name)) / calls
               for label, (_, owns) in fns.items()}
        if all(out.values()):
            return out
    raise RuntimeError(f"the profiler window shows no device time for some of {out}")


def trace_events(prof) -> list[dict]:
    """The events of a finished ``torch.profiler`` window's Chrome trace."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def kernel_times(prof) -> dict[str, list]:
    """``{kernel name: [total ms, calls]}`` from a finished ``torch.profiler``
    window's trace (its ``kernel`` events)."""
    totals: dict[str, list] = {}
    for e in trace_events(prof):
        if e.get("cat") == "kernel":
            tot = totals.setdefault(e["name"], [0.0, 0])
            tot[0] += e["dur"] / 1e3  # µs -> ms
            tot[1] += 1
    return totals


def phase_kernel() -> dict:
    """Check every ``KERNEL_CASES`` row and the planted tail bugs, probe tf32x3's
    numerics (``probe_numerics``), then time each variant (``TIMED``), the
    throughput cases through several variants (``THROUGHPUT_TIMED``), each SD-family
    shape (``SHAPES_TIMED``) and the device time of the small calls
    (``DEVICE_TIMED``). Returns ``{variant: timing row}``."""
    import torch
    import torch.nn.functional as F

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    controls = {}
    kept = {}
    timed_cases = ({c for c, *_ in TIMED.values()} | set(SHAPES_TIMED) | set(THROUGHPUT_TIMED)
                   | set(DEVICE_TIMED))
    for name, qshape, kshape, dtype_name, layout, want_variant in KERNEL_CASES:
        q, k, v = make_case(qshape, kshape, dtype_name, layout, gen, dev)
        variant = fa.kernel_variant(q, k, v)
        before = dict(fa.launches_by_variant)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.launches_by_variant.items() if c != before[n]}
        res = kernel_error(got, q, k, v)
        cases.append({"case": name, "q": list(qshape), "k": list(kshape), "dtype": dtype_name,
                      "layout": layout, "variant": variant, **res,
                      "limits": KERNEL_LIMITS[dtype_name]})
        if variant != want_variant or launched != {want_variant: 1}:
            emit({"phase": "kernel", "cases": cases})
            raise RuntimeError(f"{name}: variant {variant} launched {launched}, "
                               f"want one {want_variant} launch")
        if not res["ok"]:
            emit({"phase": "kernel", "cases": cases})
            raise RuntimeError(f"flash_attention disagrees with its plain version at {name}")
        if name in TAIL_BUG_CASES:
            controls[name] = {bug: kernel_error(out.to(q.dtype), q, k, v)
                              for bug, out in tail_bugs(q, k, v).items()}
        if name in timed_cases:
            kept[name] = (q, k, v, res["max_abs_err"])
        del q, k, v, got
    if set(controls) != set(TAIL_BUG_CASES) or any(
            c["ok"] for bugs in controls.values() for c in bugs.values()):
        emit({"phase": "kernel", "cases": cases, "controls": controls})
        raise RuntimeError(f"the kernel check accepts a planted tail bug: {controls}")
    probe = probe_numerics(dev)
    if probe["tf32_operand"] != "truncates":
        emit({"phase": "kernel", "cases": cases, "controls": controls, "numerics_probe": probe})
        raise RuntimeError(f"tf32x3 reads raw f32 words as TF32 hi parts, but this card's "
                           f"tensor cores do not truncate them: {probe}")
    rows = {}
    for variant, (case, dtype_name, iters, plain_iters) in TIMED.items():
        q, k, v, err = kept[case]
        if str(q.dtype) != f"torch.{dtype_name}":
            q, k, v = (t.to(getattr(torch, dtype_name)) for t in (q, k, v))
            err = None
        if err is None or variant != fa.kernel_variant(q, k, v):
            forced = kernel_error(fa._launch(q, k, v, q.shape[-1] ** -0.5, variant), q, k, v)
            if not forced["ok"]:
                raise RuntimeError(f"the {variant} variant disagrees at {case}: {forced}")
            err = forced["max_abs_err"]
        rows[variant] = {"case": case, **time_variant(fa, variant, q, k, v, iters, plain_iters),
                         "max_abs_err": err}
    throughput = {}
    for case, (variants, iters, plain_iters) in THROUGHPUT_TIMED.items():
        q, k, v, _ = kept[case]
        throughput[case] = {}
        for variant in variants:
            forced = kernel_error(fa._launch(q, k, v, q.shape[-1] ** -0.5, variant), q, k, v)
            if not forced["ok"]:
                raise RuntimeError(f"the {variant} variant disagrees at {case}: {forced}")
            throughput[case][variant] = {
                **time_variant(fa, variant, q, k, v, iters, plain_iters),
                "max_abs_err": forced["max_abs_err"]}
    shapes = {}
    for case, (iters, plain_iters) in SHAPES_TIMED.items():
        q, k, v, err = kept[case]
        variant = fa.kernel_variant(q, k, v)
        one = (dict(plain_batch=1, plain_heads=1)
               if plain_logit_bytes(q.shape, k.shape) > PLAIN_SLICE_BYTES else {})
        row = time_variant(fa, variant, q, k, v, iters, plain_iters, **one)
        row["loop_ms"] = loop_ms(lambda: fa._launch(q, k, v, q.shape[-1] ** -0.5, variant),
                                 iters)
        shapes[case] = {**row, "max_abs_err": err}
    device = {}
    for case, (calls, forced) in DEVICE_TIMED.items():
        q, k, v, _ = kept[case]
        scale = q.shape[-1] ** -0.5
        variant = fa.kernel_variant(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = device_ms({
            "ms": (lambda: fa._launch(q, k, v, scale, variant),
                   lambda name: f"flash_fwd_{variant}" in name),
            f"{forced}_ms": (lambda: fa._launch(q, k, v, scale, forced),
                             lambda name: f"flash_fwd_{forced}" in name),
            "library_ms": (lambda: F.scaled_dot_product_attention(qt, kt, vt),
                           lambda name: not any(f"flash_fwd_{v}" in name for v in fa.VARIANTS)),
        }, calls)
        shape = (tuple(q.shape), tuple(k.shape), q.element_size())
        device[case] = {
            "variant": variant, **ms, "library_backend": sdpa_backend(qt, kt, vt),
            "calls": calls, "bound_ms": attention_bound_ms(*shape, peak_flops(variant))[0],
            f"{forced}_bound_ms": attention_bound_ms(*shape, peak_flops(forced))[0]}
    emit({"phase": "kernel", "cases": cases, "controls": controls, "numerics_probe": probe,
          "timed": rows, "timed_throughput": throughput, "timed_shapes": shapes,
          "device_timed": device, "seconds": time.perf_counter() - start})
    return rows


def phase_main_path():
    """Returns the parallelized FLUX-dev model, K1's launches by variant, and the
    main path's inputs, latents (1 step and ``STEPS``) and s/it for the stream phase
    to hold its runs to."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.flux import build_flux, flux_dev_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.flow import flow_euler_sample

    dev = torch.device("cuda", 0)
    cfg = flux_dev_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = build_flux(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pm = parallelize(model, [("cuda:0", 100)])

    def inputs(batch):
        x = torch.randn((batch, 128, 128, 16), generator=gen, device=dev)
        ctx = torch.randn((batch, 512, cfg.context_in_dim), generator=gen, device=dev)
        y = torch.randn((batch, cfg.vec_in_dim), generator=gen, device=dev)
        return x, ctx, y

    x, ctx, y = inputs(1)
    latent_1 = flow_euler_sample(pm, x, ctx, steps=1, guidance=3.5, y=y)  # warm-up, not counted
    torch.cuda.synchronize()

    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    attention._RESOLVED.clear()
    torch.cuda.synchronize()
    start = time.perf_counter()
    latent = flow_euler_sample(pm, x, ctx, steps=STEPS, guidance=3.5, y=y, callback=on_step)
    torch.cuda.synchronize()
    launches = fa.launches
    by_variant = dict(fa.launches_by_variant)
    resolved = attention.resolved_backends()
    step_s = [b - a for a, b in zip([start] + stamps[:-1], stamps)]
    finite = bool(torch.isfinite(latent).all().item())
    per_step = cfg.depth + cfg.depth_single_blocks
    result = {
        "phase": "main_path", "model": "flux-dev", "n_params": model.n_params(),
        "weight_bytes": sum(p.numel() * p.element_size() for p in model.module.parameters()),
        "build_s": build_s, "batch": 1, "latent": list(latent.shape), "steps": STEPS,
        "s_per_it": sum(step_s) / len(step_s), "step_s": step_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "resolved_backends": list(resolved), "k1_launches": launches,
        "k1_launches_by_variant": by_variant,
        "k1_launches_expected": per_step * STEPS, "finite": finite,
    }
    emit(result)
    if resolved != ("pallas",) or launches != per_step * STEPS or not finite \
            or by_variant["sm90"] != launches or tuple(latent.shape) != tuple(x.shape):
        raise RuntimeError(f"main path check failed: {result}")

    # The same forward on the plain attention path (chunked math, f32 softmax).
    t = torch.full((1,), 0.5, device=dev)
    g = torch.full((1,), 3.5, device=dev)
    out_k = pm(x, t, ctx, y=y, guidance=g).float()
    attention.set_attention_backend("xla")
    try:
        out_p = pm(x, t, ctx, y=y, guidance=g).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    emit({"phase": "main_path_vs_plain_attention", "rel_l2_err": rel,
          "max_abs_err": (out_k - out_p).abs().max().item(), "tol": MAIN_PATH_REL_TOL})
    if not rel <= MAIN_PATH_REL_TOL:
        raise RuntimeError(f"FLUX-dev forward through K1 disagrees with plain attention: {rel}")

    x2, ctx2, y2 = inputs(2)
    before = fa.launches_by_variant["sm90"]
    t0 = time.perf_counter()
    out2 = flow_euler_sample(pm, x2, ctx2, steps=1, guidance=3.5, y=y2)
    torch.cuda.synchronize()
    b2 = {"phase": "main_path_batch2", "s_per_it": time.perf_counter() - t0,
          "latent": list(out2.shape), "k1_sm90_launches": fa.launches_by_variant["sm90"] - before,
          "finite": bool(torch.isfinite(out2).all().item())}
    emit(b2)
    if not b2["finite"] or b2["k1_sm90_launches"] != per_step \
            or tuple(out2.shape) != tuple(x2.shape):
        raise RuntimeError(f"batch-2 step check failed: {b2}")
    phase_profile(pm, x, ctx, y)
    ref = {"x": x, "ctx": ctx, "y": y, "latent_1": latent_1, "latent": latent,
           "s_per_it": result["s_per_it"]}
    return pm, by_variant, ref


def phase_main_path_captured(pm) -> dict:
    """The main path's 4 FLUX-dev steps (inputs drawn anew, the main path's shapes)
    with the whole loop captured as a CUDA graph, against the eager loop in turns
    (``captured_turns``): exactly 57 ``sm90`` a forward, 4 forwards a replay; then the
    numerics sentinel on the same loop and a ``compile-fail`` plan
    (``sentinel_captured``). It runs after the pipeline phase, whose peak memory it
    would otherwise raise by the capture stream's cuBLAS workspace. Returns K1's
    launches by variant by path (the replays' for the captured ones)."""
    import tempfile

    import torch

    from comfyui_parallelanything_tpu_torch.sampling import compiled
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    gc.collect()  # the pipeline phase's text towers and VAE, held by reference cycles
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = pm.model_config
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((1, 128, 128, 16), generator=gen, device=dev)
    ctx = torch.randn((1, 512, cfg.context_in_dim), generator=gen, device=dev)
    y = torch.randn((1, cfg.vec_in_dim), generator=gen, device=dev)
    run = lambda c: run_sampler(  # noqa: E731
        pm, x, ctx, sampler="flow_euler", steps=STEPS, guidance=3.5, y=y, compile_loop=c)
    per_replay = {"sm90": (cfg.depth + cfg.depth_single_blocks) * STEPS}
    captured = captured_turns("main_path_captured", run, STEPS, per_replay)
    compiled.clear_compiled_loops()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        sentinel = sentinel_captured("main_path_sentinel", run, per_replay,
                                     {"sm90": cfg.depth + cfg.depth_single_blocks}, d)
    return {"main_path_captured": captured["k1_replayed_launches"], **sentinel}


def phase_profile(pm, x, ctx, y) -> None:
    """One FLUX-dev step under ``torch.profiler`` (``profile_step``)."""
    from comfyui_parallelanything_tpu_torch.sampling.flow import flow_euler_sample

    profile_step("profile", lambda: flow_euler_sample(pm, x, ctx, steps=1, guidance=3.5, y=y))


def profile_step(phase: str, step, require_k1: bool = True) -> dict:
    """``step()`` under ``torch.profiler``: the top 10 CUDA kernels by total device
    time, K1's share of all kernel time and of the step, and the device's busy share
    (kernel time over the step's wall time, one stream, so kernels do not overlap).
    Kernel times come from the profiler's trace (its ``kernel`` events). A replayed
    CUDA graph's kernels are reported only where the tracer sees inside graphs:
    ``require_k1=False`` records the window without failing when it shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    totals = kernel_times(prof)
    kernel_ms = sum(t[0] for t in totals.values())
    k1_ms = sum(t[0] for n, t in totals.items() if "flash_fwd" in n)
    k1_calls = sum(t[1] for n, t in totals.items() if "flash_fwd" in n)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    result = {
        "phase": phase, "step_wall_s": wall_s, "kernel_ms": kernel_ms,
        "busy_share": kernel_ms / (wall_s * 1e3), "k1_ms": k1_ms, "k1_calls": k1_calls,
        "k1_share_of_kernels": k1_ms / kernel_ms if kernel_ms else None,
        "k1_share_of_step": k1_ms / (wall_s * 1e3),
        "top10": [{"kernel": n[:160], "ms": t[0], "calls": t[1],
                   "share_of_kernels": t[0] / kernel_ms} for n, t in top],
    }
    emit(result)
    if require_k1 and (not kernel_ms or k1_calls == 0):
        raise RuntimeError(f"the profiled step shows no K1 kernel: {result}")
    return result


# The captured loop against the eager loop on the same inputs: the same kernels in
# the same order, so 0 is expected; the limit only allows for a library picking
# another algorithm under capture.
CAPTURED_REL_TOL = 1e-3


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def compile_eager_rungs() -> float:
    """``pa_degradation_total{rung="compile-eager"}`` so far: a captured phase must
    leave it unchanged, so the eager fallback cannot hide a capture failure."""
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    return registry.get("pa_degradation_total", {"rung": "compile-eager"}) or 0.0


def replayed_launches(records) -> dict[str, int]:
    """K1's launches by variant that cached loops' replays made: each loop's
    launches recorded at its capture times its replays, summed."""
    total: dict[str, int] = {}
    for rec in records:
        for v, n in rec["captured"].items():
            total[v] = total.get(v, 0) + n * rec["replays"]
    return total


def captured_turns(phase: str, run, steps: int, per_replay: dict, denoise_of=None) -> dict:
    """One sampler run, ``run(compile_loop)``, captured by a first call (warm-up,
    capture, one replay; its seconds and the capture's own), then eager and captured
    in turns E, C, C, E: each run's seconds, s/it (of ``denoise_of(seconds)`` where
    the run also encodes and decodes) and peak memory, the graph's pool included;
    the captured output against the eager one (relative L2 within
    ``CAPTURED_REL_TOL``, and whether bitwise equal). The one cached loop must have
    recorded ``per_replay`` K1 launches by variant at its capture and been replayed
    by each of the three captured calls: a captured call that ran eager fails the
    phase. ``k1_replayed_launches`` is the captured launches times the replays."""
    import torch

    from comfyui_parallelanything_tpu_torch.sampling import compiled

    dev = torch.device("cuda", 0)
    compiled.clear_compiled_loops()
    rungs0 = compile_eager_rungs()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    run(True)
    torch.cuda.synchronize()
    capture_call_s = time.perf_counter() - start
    capture_peak = torch.cuda.max_memory_allocated(dev)
    runs, outs = [], {}
    for mode in ("eager", "captured", "captured", "eager"):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run(mode == "captured")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        denoise_s = denoise_of(seconds) if denoise_of else seconds
        runs.append({"mode": mode, "seconds": seconds, "s_per_it": denoise_s / steps,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
        outs.setdefault(mode, out)
    records = compiled.loop_records()
    replayed = replayed_launches(records)
    got, want = outs["captured"], outs["eager"]
    res = {
        "phase": phase, "steps": steps, "runs": runs,
        "capture_call_s": capture_call_s, "capture_call_max_memory_allocated": capture_peak,
        "loops": records, "rel_l2_vs_eager": rel_l2(got, want),
        "max_abs_err_vs_eager": (got.float() - want.float()).abs().max().item(),
        "bitwise_equal": bool(torch.equal(got, want)), "tol": CAPTURED_REL_TOL,
        "finite": bool(torch.isfinite(got).all().item()),
        "k1_captured_per_replay": per_replay, "k1_replayed_launches": replayed,
        "compile_eager_rungs": compile_eager_rungs() - rungs0,
    }
    emit(res)
    if not (len(records) == 1 and records[0]["replays"] == 3 and res["compile_eager_rungs"] == 0
            and records[0]["captured"] == per_replay and res["finite"]
            and res["rel_l2_vs_eager"] <= CAPTURED_REL_TOL
            and replayed == {v: 3 * n for v, n in per_replay.items()}):
        raise RuntimeError(f"{phase} check failed: {res}")
    return res


PIPELINE_PROMPT = "a photograph of an astronaut riding a horse on the moon, highly detailed"
PIPELINE_REL_TOL = 5e-2  # bf16 FLUX VAE decode, K1 vs plain attention


def synthetic_tokenizers(t5_len: int = 512):
    """A CLIP byte-BPE tokenizer over a small synthetic vocab (every byte symbol,
    alone and with ``</w>``, and a few merges) whose BOS/EOS ids are CLIP-L's
    49406/49407, and a T5-style tokenizer (``t5_len`` tokens, EOS 1, pad 0) over the
    same pieces: real tokenizer tables are downloads, which the run may not make."""
    from comfyui_parallelanything_tpu_torch.utils.tokenizer import (
        CLIPBPETokenizer,
        JsonTokenizer,
        _bytes_to_unicode,
    )

    symbols = list(_bytes_to_unicode().values())
    merges = [("a", "s"), ("t", "r"), ("o", "n</w>"), ("h", "o"), ("ho", "r"),
              ("hor", "s"), ("hors", "e</w>"), ("m", "o"), ("mo", "on</w>")]
    vocab = {}
    for piece in symbols + [p + "</w>" for p in symbols] + [a + b for a, b in merges]:
        vocab.setdefault(piece, len(vocab) + 2)  # ids 0 and 1 are T5's pad and EOS
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    clip = CLIPBPETokenizer(vocab, merges, max_len=77)

    class _Pieces:  # the ``tokenizers`` interface JsonTokenizer reads: encode(t).ids
        def encode(self, text):
            return type("Encoding", (), {"ids": clip.encode(text)})()

    return clip, JsonTokenizer(_Pieces(), max_len=t5_len, eos_id=1, pad_id=0)


def _timed_span(spans: dict, name: str, fn):
    """``fn`` wrapped to add its synchronised wall time to ``spans[name]`` and to
    stamp its last end in ``spans[name + "_end"]``."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spans[name + "_end"] = time.perf_counter()
        spans[name] = spans.get(name, 0.0) + spans[name + "_end"] - start
        return out

    return run


def phase_pipeline(pm) -> dict:
    """``FluxPipeline`` at full width: the main path's FLUX-dev, CLIP-L, T5-XXL and
    the FLUX VAE with random weights from a seeded generator, 1024², batch 1, 4
    steps, guidance 3.5; then one img2img call (denoise 0.5, 2 steps) on its
    output. K1 must serve every attention call of the DiT (``sm90``) and of the
    VAE's mid blocks (``wide``); the images must be finite, (1, 1024, 1024, 3) and
    in [0, 1]; the decode through K1 must agree with the same decode on the plain
    attention path. Returns K1's launches by variant in each call."""
    import torch

    from comfyui_parallelanything_tpu_torch.models.text_encoders import (
        build_clip_text,
        build_t5_encoder,
        clip_l_config,
        t5_xxl_config,
    )
    from comfyui_parallelanything_tpu_torch.models.vae import build_vae, flux_vae_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.pipelines import FluxPipeline

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    clip = build_clip_text(clip_l_config(), device=dev, generator=gen)
    t5 = build_t5_encoder(t5_xxl_config(), device=dev, generator=gen)
    vae = build_vae(flux_vae_config(), device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    clip_tok, t5_tok = synthetic_tokenizers()
    pipe = FluxPipeline(dit=pm, vae=vae, clip=clip, t5=t5, tokenizer=clip_tok,
                        t5_tokenizer=t5_tok)

    def nbytes(module):
        return sum(p.numel() * p.element_size() for p in module.parameters())

    spans: dict[str, float] = {}
    pipe.encode_prompt = _timed_span(spans, "encode_s", pipe.encode_prompt)
    vae.decode = _timed_span(spans, "decode_s", vae.decode)
    vae.encode = _timed_span(spans, "vae_encode_s", vae.encode)
    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    kw = dict(height=1024, width=1024, guidance=3.5)
    # Warm-up (text encoders, VAE encoder and decoder), not counted: img2img, 1 step.
    pipe(PIPELINE_PROMPT, steps=1, rng=torch.Generator(device=dev).manual_seed(3),
         init_image=torch.full((1, 1024, 1024, 3), 0.5, device=dev), denoise=0.5, **kw)
    torch.cuda.synchronize()

    def run(**call):
        spans.clear()
        stamps.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_launches()
        attention._RESOLVED.clear()
        torch.cuda.synchronize()
        start = time.perf_counter()
        img = pipe(PIPELINE_PROMPT, rng=torch.Generator(device=dev).manual_seed(4),
                   callback=on_step, **kw, **call)
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        launches = dict(fa.launches_by_variant)
        first = spans.get("vae_encode_s_end", spans["encode_s_end"])
        step_s = [b - a for a, b in zip([first] + stamps[:-1], stamps)]
        return img, {
            "total_s": total, "encode_s": spans["encode_s"],
            "vae_encode_s": spans.get("vae_encode_s"), "decode_s": spans["decode_s"],
            "s_per_it": sum(step_s) / len(step_s), "step_s": step_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "k1_launches_by_variant": launches,
            "resolved_backends": list(attention.resolved_backends()),
            "image": list(img.shape), "finite": bool(torch.isfinite(img).all().item()),
            "min": img.min().item(), "max": img.max().item(),
        }

    def check(res, steps, wide):
        want = {"sm90": 57 * steps, "wide": wide}
        return (res["image"] == [1, 1024, 1024, 3] and res["finite"] and res["min"] >= 0.0
                and res["max"] <= 1.0 and res["resolved_backends"] == ["pallas"]
                and {n: c for n, c in res["k1_launches_by_variant"].items() if c} == want)

    img, txt2img = run(steps=STEPS)
    result = {"phase": "pipeline", "build_s": build_s,
              "weight_bytes": {"flux": nbytes(pm._module), "clip_l": nbytes(clip.module),
                               "t5_xxl": nbytes(t5.module),
                               "vae": nbytes(vae.module)},
              "steps": STEPS, "txt2img": txt2img}
    emit(result)
    if not check(txt2img, STEPS, 1):
        raise RuntimeError(f"pipeline check failed: {txt2img}")

    _, img2img = run(steps=2, init_image=img, denoise=0.5)
    emit({"phase": "pipeline_img2img", "denoise": 0.5, "steps": 2, **img2img})
    if not check(img2img, 2, 2):
        raise RuntimeError(f"img2img check failed: {img2img}")

    # The same decode through K1 and on the plain attention path.
    z = torch.randn((1, 128, 128, 16), generator=gen, device=dev)
    out_k = vae.decode(z).float()
    attention.set_attention_backend("xla")
    try:
        out_p = vae.decode(z).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    emit({"phase": "vae_decode_vs_plain_attention", "rel_l2_err": rel,
          "max_abs_err": (out_k - out_p).abs().max().item(), "tol": PIPELINE_REL_TOL})
    if not rel <= PIPELINE_REL_TOL:
        raise RuntimeError(f"FLUX VAE decode through K1 disagrees with plain attention: {rel}")
    return {"txt2img": txt2img["k1_launches_by_variant"],
            "img2img": img2img["k1_launches_by_variant"]}


SD_STEPS = 8
SD_CFG = 7.0
SD_NEGATIVE = "blurry, low quality"
SD_REL_TOL = 5e-2  # bf16 SDXL and SD1.5 UNet forwards, K1 vs plain attention
SDXL_SM90_PER_STEP = 140  # 70 transformer blocks × (self + cross), CFG in one call
SD15_PER_FORWARD = {"sm90": 20, "wide": 10}  # head dims 40 and 80; 160


def _launched(fa) -> dict:
    return {n: c for n, c in fa.launches_by_variant.items() if c}


def phase_sd_pipeline() -> dict:
    """``StableDiffusionPipeline`` with SDXL-base at full width (CLIP-L, OpenCLIP-G,
    the SDXL VAE; random bf16 weights from a seeded generator), the UNet through
    ``parallelize``: 1024², batch 1, ``SD_STEPS`` steps of dpmpp_2m/karras at CFG
    ``SD_CFG``. Returns K1's launches by variant in that run."""
    import copy

    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.text_encoders import (
        build_clip_text,
        clip_l_config,
        open_clip_g_config,
    )
    from comfyui_parallelanything_tpu_torch.models.unet import build_unet, sdxl_config
    from comfyui_parallelanything_tpu_torch.models.vae import build_vae, sdxl_vae_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.pipelines import StableDiffusionPipeline
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    unet = build_unet(sdxl_config(), device=dev, generator=gen)
    clip_l = build_clip_text(clip_l_config(), device=dev, generator=gen)
    clip_g = build_clip_text(open_clip_g_config(), device=dev, generator=gen)
    vae = build_vae(sdxl_vae_config(), device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tok_l, _ = synthetic_tokenizers()
    tok_g = copy.copy(tok_l)
    tok_g.pad_id = 0  # OpenCLIP-G pads with 0, CLIP-L with EOS
    pm = parallelize(unet, [("cuda:0", 100)])
    pipe = StableDiffusionPipeline(unet=pm, vae=vae, clip=clip_l, tokenizer=tok_l,
                                   clip_g=clip_g, tokenizer_g=tok_g)

    def nbytes(module):
        return sum(p.numel() * p.element_size() for p in module.parameters())

    spans: dict[str, float] = {}
    pipe.encode_prompt = _timed_span(spans, "encode_s", pipe.encode_prompt)
    vae.decode = _timed_span(spans, "decode_s", vae.decode)
    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    kw = dict(height=1024, width=1024, cfg_scale=SD_CFG, sampler="dpmpp_2m", karras=True)
    # Warm-up (encoders, UNet, VAE decoder), not counted: one step.
    pipe(PIPELINE_PROMPT, SD_NEGATIVE, steps=1, **kw)
    torch.cuda.synchronize()
    spans.clear()
    fa.reset_launches()
    attention._RESOLVED.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    img = pipe(PIPELINE_PROMPT, SD_NEGATIVE, steps=SD_STEPS,
               rng=torch.Generator(device=dev).manual_seed(6), callback=on_step, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    launches = _launched(fa)
    resolved = list(attention.resolved_backends())
    peak = torch.cuda.max_memory_allocated(dev)
    # Step i runs from the end of step i-1 (the first: the end of the encodes).
    step_s = [b - a for a, b in zip([spans["encode_s_end"]] + stamps[:-1], stamps)]
    res = {
        "phase": "sd_pipeline", "model": "sdxl-base", "build_s": build_s,
        "n_params": {"unet": unet.n_params(),
                     "clip_l": sum(p.numel() for p in clip_l.module.parameters()),
                     "clip_g": sum(p.numel() for p in clip_g.module.parameters()),
                     "vae": sum(p.numel() for p in vae.module.parameters())},
        "weight_bytes": {"unet": nbytes(unet.module), "clip_l": nbytes(clip_l.module),
                         "clip_g": nbytes(clip_g.module), "vae": nbytes(vae.module)},
        "steps": SD_STEPS, "cfg_scale": SD_CFG, "total_s": total,
        "encode_s": spans["encode_s"], "decode_s": spans["decode_s"],
        "s_per_it": sum(step_s) / len(step_s), "step_s": step_s,
        "max_memory_allocated": peak, "k1_launches_by_variant": launches,
        "k1_launches_expected": {"sm90": SDXL_SM90_PER_STEP * SD_STEPS, "wide": 1},
        "resolved_backends": resolved, "image": list(img.shape),
        "finite": bool(torch.isfinite(img).all().item()),
        "min": img.min().item(), "max": img.max().item(),
    }
    emit(res)
    if (launches != res["k1_launches_expected"] or resolved != ["pallas"]
            or res["image"] != [1, 1024, 1024, 3] or not res["finite"]
            or res["min"] < 0.0 or res["max"] > 1.0):
        raise RuntimeError(f"sd_pipeline check failed: {res}")

    # One UNet forward (batch 2, as CFG runs it) through K1 and on plain attention.
    x = torch.randn((2, 128, 128, 4), generator=gen, device=dev)
    t = torch.tensor([999.0, 999.0], device=dev)
    ctx = torch.randn((2, 77, 2048), generator=gen, device=dev)
    y = torch.randn((2, 2816), generator=gen, device=dev)
    out_k = pm(x, t, ctx, y=y).float()
    attention.set_attention_backend("xla")
    try:
        out_p = pm(x, t, ctx, y=y).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    emit({"phase": "sd_unet_vs_plain_attention", "rel_l2_err": rel,
          "max_abs_err": (out_k - out_p).abs().max().item(), "tol": SD_REL_TOL,
          "finite": bool(torch.isfinite(out_k).all().item())})
    if not rel <= SD_REL_TOL:
        raise RuntimeError(f"SDXL UNet forward through K1 disagrees with plain attention: {rel}")

    # One denoise step (CFG, batch 2) under the profiler.
    context, y1 = pipe.encode_prompt([PIPELINE_PROMPT], 1024, 1024)
    uctx, uy = pipe.encode_prompt([SD_NEGATIVE], 1024, 1024)
    noise = torch.randn((1, 128, 128, 4), generator=gen, device=dev)
    profile_step("sd_profile", lambda: run_sampler(
        pm, noise, context, sampler="dpmpp_2m", steps=1, cfg_scale=SD_CFG,
        uncond_context=uctx, uncond_kwargs={"y": uy}, y=y1))

    # The pipeline with its denoise loop captured, against the eager pipeline in turns
    # (s/it from the denoise: the run less its encode and decode spans).
    from comfyui_parallelanything_tpu_torch.sampling import compiled

    def run_pipe(compile_loop):
        spans.clear()
        return pipe(PIPELINE_PROMPT, SD_NEGATIVE, steps=SD_STEPS, compile_loop=compile_loop,
                    rng=torch.Generator(device=dev).manual_seed(6), **kw)

    captured = captured_turns("sd_pipeline_captured", run_pipe, SD_STEPS,
                              {"sm90": SDXL_SM90_PER_STEP * SD_STEPS},
                              denoise_of=lambda s: s - spans["encode_s"] - spans["decode_s"])
    # One captured denoise (the pipeline's cached loop, replayed) under the profiler.
    profile_step("sd_profile_captured", lambda: run_sampler(
        pm, noise, context, sampler="dpmpp_2m", steps=SD_STEPS, cfg_scale=SD_CFG,
        uncond_context=uctx, uncond_kwargs={"y": uy}, y=y1, compile_loop=True),
        require_k1=False)
    compiled.clear_compiled_loops()
    torch.cuda.empty_cache()
    return launches, captured["k1_replayed_launches"]


SD15_MULTISTEP = ("lms", "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_3m_sde", "uni_pc", "uni_pc_bh2")


def phase_sd_samplers() -> dict:
    """SD1.5 at full width at 512² through ``parallelize`` → ``run_sampler`` with
    every sampler name but ``flow_euler``, an img2img and an inpaint call, CFG
    ``SD_CFG``: every latent finite and K1's launches exactly ``SD15_PER_FORWARD``
    per UNet forward; then one UNet forward through K1 against the same forward on
    plain attention; the captured loops, the numerics sentinel on dpmpp_2m's captured
    loop with a ``compile-fail`` plan (``sentinel_captured``) and the capture fallback.
    Returns K1's launches by variant over the sampler calls."""
    import tempfile

    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.unet import build_unet, sd15_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import SAMPLER_NAMES, run_sampler

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    unet = build_unet(sd15_config(), device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pm = parallelize(unet, [("cuda:0", 100)])
    forwards = [0]

    def counted(x, t, context=None, **kw):
        forwards[0] += 1
        return pm(x, t, context, **kw)

    noise = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    ctx = torch.randn((1, 77, 768), generator=gen, device=dev)
    uctx = torch.randn((1, 77, 768), generator=gen, device=dev)
    init = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    mask = (torch.rand((1, 64, 64, 1), generator=gen, device=dev) > 0.5).float()
    common = dict(cfg_scale=SD_CFG, uncond_context=uctx)
    run_sampler(counted, noise, ctx, sampler="euler", steps=1, **common)  # warm-up
    torch.cuda.synchronize()
    calls = [(name, dict(sampler=name, steps=3 if name in SD15_MULTISTEP else 2))
             for name in SAMPLER_NAMES if name != "flow_euler"]
    calls += [("img2img", dict(sampler="dpmpp_2m", steps=2, init_latent=init, denoise=0.5)),
              ("inpaint", dict(sampler="euler_ancestral", steps=2, init_latent=init,
                               latent_mask=mask))]
    rows, total, outs = {}, dict.fromkeys(fa.VARIANTS, 0), {}
    for name, kw in calls:
        forwards[0] = 0
        fa.reset_launches()
        t0 = time.perf_counter()
        out = run_sampler(counted, noise, ctx, rng=torch.Generator(device=dev).manual_seed(8),
                          **common, **kw)
        torch.cuda.synchronize()
        launched = _launched(fa)
        outs[name] = out
        want = {v: n * forwards[0] for v, n in SD15_PER_FORWARD.items()}
        rows[name] = {"steps": kw["steps"], "forwards": forwards[0], "seconds":
                      time.perf_counter() - t0, "k1_launches_by_variant": launched,
                      "finite": bool(torch.isfinite(out).all().item()),
                      "shape": list(out.shape)}
        for v, n in fa.launches_by_variant.items():
            total[v] += n
        if launched != want or not rows[name]["finite"] or rows[name]["shape"] != [1, 64, 64, 4]:
            emit({"phase": "sd_samplers", "model": "sd15", "runs": rows})
            raise RuntimeError(f"sd_samplers check failed at {name}: {rows[name]}, want {want}")

    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    start = time.perf_counter()
    run_sampler(pm, noise, ctx, sampler="dpmpp_2m", steps=10, callback=on_step, **common)
    step_s = [b - a for a, b in zip([start] + stamps[:-1], stamps)]
    emit({"phase": "sd_samplers", "model": "sd15", "n_params": unet.n_params(),
          "build_s": build_s, "runs": rows, "dpmpp_2m_s_per_it": sum(step_s) / len(step_s),
          "dpmpp_2m_step_s": step_s, "k1_launches_by_variant": total})

    # One UNet forward (batch 2, as CFG runs it) through K1 and on plain attention:
    # head dims 40 and 80 on sm90 with 77-key cross-attention tails, 160 on wide.
    x = torch.cat([noise, init])
    t = torch.tensor([999.0, 999.0], device=dev)
    out_k = pm(x, t, torch.cat([ctx, uctx])).float()
    attention.set_attention_backend("xla")
    try:
        out_p = pm(x, t, torch.cat([ctx, uctx])).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    emit({"phase": "sd15_unet_vs_plain_attention", "rel_l2_err": rel,
          "max_abs_err": (out_k - out_p).abs().max().item(), "tol": SD_REL_TOL,
          "finite": bool(torch.isfinite(out_k).all().item())})
    if not rel <= SD_REL_TOL:
        raise RuntimeError(f"SD1.5 UNet forward through K1 disagrees with plain attention: {rel}")
    profile_step("sd15_profile", lambda: run_sampler(pm, noise, ctx, sampler="dpmpp_2m",
                                                     steps=1, **common))

    # Every call again with its loop captured (same generator seeds): each within
    # CAPTURED_REL_TOL of its eager run, its capture holding exactly SD15_PER_FORWARD
    # launches per forward, replayed once.
    from comfyui_parallelanything_tpu_torch.sampling import compiled

    compiled.clear_compiled_loops()
    captured_rows = {}
    rungs0 = compile_eager_rungs()
    for name, kw in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_sampler(pm, noise, ctx, rng=torch.Generator(device=dev).manual_seed(8),
                          compile_loop=True, **common, **kw)
        torch.cuda.synchronize()
        rec = compiled.loop_records()[-1]
        want = {v: n * rows[name]["forwards"] for v, n in SD15_PER_FORWARD.items()}
        captured_rows[name] = {
            "seconds": time.perf_counter() - t0, "capture_s": rec["capture_s"],
            "k1_captured": rec["captured"], "replays": rec["replays"],
            "rel_l2_vs_eager": rel_l2(got, outs[name]),
            "bitwise_equal": bool(torch.equal(got, outs[name])),
            "finite": bool(torch.isfinite(got).all().item())}
        row = captured_rows[name]
        if not (rec["sampler"] == kw["sampler"] and rec["captured"] == want
                and rec["replays"] == 1 and row["finite"] and compile_eager_rungs() == rungs0
                and row["rel_l2_vs_eager"] <= CAPTURED_REL_TOL):
            emit({"phase": "sd_samplers_captured_each", "runs": captured_rows})
            raise RuntimeError(f"captured {name} check failed: {row}, want {want}")
    each = replayed_launches(compiled.loop_records())
    emit({"phase": "sd_samplers_captured_each", "tol": CAPTURED_REL_TOL, "runs": captured_rows,
          "k1_replayed_launches": each, "compile_eager_rungs": compile_eager_rungs() - rungs0})
    captured = captured_turns(
        "sd_samplers_captured", lambda c: run_sampler(pm, noise, ctx, sampler="dpmpp_2m",
                                                      steps=10, compile_loop=c, **common),
        10, {v: 10 * n for v, n in SD15_PER_FORWARD.items()})
    profile_step("sd15_profile_captured", lambda: run_sampler(
        pm, noise, ctx, sampler="dpmpp_2m", steps=10, compile_loop=True, **common),
        require_k1=False)
    compiled.clear_compiled_loops()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        sentinel = sentinel_captured(
            "sd15_sentinel", lambda c: run_sampler(pm, noise, ctx, sampler="dpmpp_2m",
                                                   steps=10, compile_loop=c, **common),
            {v: 10 * n for v, n in SD15_PER_FORWARD.items()}, SD15_PER_FORWARD, d)
    fallback = {**capture_fallback(pm, noise, ctx, common), **sentinel}
    replayed = {v: each.get(v, 0) + captured["k1_replayed_launches"].get(v, 0)
                for v in set(each) | set(captured["k1_replayed_launches"])}
    return total, replayed, fallback, unet


CAPTURE_FALLBACK_STEPS = 4
# Device bytes a fallback may leave allocated: a broken capture's pool kept alive
# would hold a forward's activations (hundreds of MB for SD1.5 at 512²); library
# state and the result latent are far below this.
CAPTURE_FALLBACK_SLACK = 16 * 2**20


def capture_fallback(pm, noise, ctx, common) -> dict:
    """SD1.5 ``compile_loop=True`` at 512² through a model whose forward reads a
    device value on the host (``.item()``) while a CUDA graph is capturing, so the
    capture breaks on the card: the call must take the ``compile-eager`` rung exactly
    once, record a ``degradation`` span, give exactly the eager loop's latent, and
    launch K1 as the eager loop does, plus the one warm-up forward that preceded the
    broken capture; the failed loop leaves the cache, and the device's allocated and
    reserved bytes grow by less than ``CAPTURE_FALLBACK_SLACK`` (a broken graph's
    private pool, left routed or held, would keep its bytes reserved)."""
    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling import compiled
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler
    from comfyui_parallelanything_tpu_torch.utils import tracing

    forwards = [0]

    def host_read(x, t, context=None, **kw):
        forwards[0] += 1
        if torch.cuda.is_current_stream_capturing():
            float(x[0, 0, 0, 0])  # a host read: a CUDA graph cannot capture it
        return pm(x, t, context, **kw)

    kw = dict(sampler="dpmpp_2m", steps=CAPTURE_FALLBACK_STEPS, **common)
    compiled.clear_compiled_loops()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    fa.reset_launches()
    eager = run_sampler(host_read, noise, ctx, **kw)
    torch.cuda.synchronize()
    eager_launches, eager_forwards = _launched(fa), forwards[0]
    torch.cuda.empty_cache()
    allocated0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    rungs0 = compile_eager_rungs()
    tracing.enable()
    forwards[0] = 0
    fa.reset_launches()
    t0 = time.perf_counter()
    got = run_sampler(host_read, noise, ctx, compile_loop=True, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launched(fa)
    spans = [e for e in tracing.export()["traceEvents"] if e.get("name") == "degradation"]
    tracing.disable()
    tracing.tracer.clear()
    del_loops = compiled.loop_records()
    torch.cuda.empty_cache()
    per_forward = {v: n for v, n in SD15_PER_FORWARD.items()}
    want = {v: eager_launches.get(v, 0) + n for v, n in per_forward.items()}
    row = {"phase": "capture_fallback", "model": "sd15", "sampler": kw["sampler"],
           "steps": CAPTURE_FALLBACK_STEPS, "seconds": seconds,
           "compile_eager_rungs": compile_eager_rungs() - rungs0,
           "degradation_spans": [e["args"] for e in spans],
           "bitwise_vs_eager": bool(torch.equal(got, eager)), "rel_l2_vs_eager": rel_l2(got, eager),
           "eager_forwards": eager_forwards, "fallback_forwards": forwards[0],
           "k1_launches_by_variant": launches, "k1_eager_launches": eager_launches,
           "k1_launches_expected": want, "cached_loops_after": len(del_loops),
           "allocated_before": allocated0, "allocated_after": torch.cuda.memory_allocated(),
           "reserved_before": reserved0, "reserved_after": torch.cuda.memory_reserved()}
    emit(row)
    if not (row["compile_eager_rungs"] == 1 and len(spans) == 1
            and spans[0]["args"]["rung"] == "compile-eager" and row["bitwise_vs_eager"]
            and launches == want and not del_loops
            and row["allocated_after"] <= allocated0 + CAPTURE_FALLBACK_SLACK
            and row["reserved_after"] <= reserved0 + CAPTURE_FALLBACK_SLACK):
        raise RuntimeError(f"capture_fallback check failed: {row}")
    return {"capture_fallback": launches}


SD15_F32_PER_FORWARD = {"tf32x3": 30}  # head dims 40, 80 and 160, 10 calls each; no f32
SD15_F32_STEPS = 4
# The f32 SD1.5 UNet forward through K1 against the same forward on plain attention:
# both in full f32 (TF32 off), so they differ by tf32x3's error (relative L2 about
# 1e-6 a call on randn inputs) carried through the UNet, and by summation order.
SD15_F32_REL_TOL = 1e-4


def phase_sd15_f32() -> dict:
    """SD1.5 at full width in float32 (``sd15_config(dtype=float32)``), TF32 off for
    matmuls and convolutions (restored after), at 512², CFG ``SD_CFG``, through
    ``parallelize``: one batch-2 UNet forward through K1 against the same forward on
    plain attention, then ``dpmpp_2m`` for ``SD15_F32_STEPS`` steps (s/it, peak
    memory). K1 must launch exactly ``SD15_F32_PER_FORWARD`` per UNet forward in both.
    Returns K1's launches by variant in the sampler run."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.unet import build_unet, sd15_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    dev = torch.device("cuda", 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator(device=dev).manual_seed(9)
        t0 = time.perf_counter()
        unet = build_unet(sd15_config(dtype=torch.float32), device=dev, generator=gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pm = parallelize(unet, [("cuda:0", 100)])
        noise = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
        ctx = torch.randn((1, 77, 768), generator=gen, device=dev)
        uctx = torch.randn((1, 77, 768), generator=gen, device=dev)

        # One UNet forward (batch 2, as CFG runs it) through K1 and on plain attention.
        x = torch.cat([noise, torch.randn((1, 64, 64, 4), generator=gen, device=dev)])
        t = torch.tensor([999.0, 999.0], device=dev)
        c = torch.cat([ctx, uctx])
        pm(x, t, c)  # warm-up, not counted
        fa.reset_launches()
        out_k = pm(x, t, c)
        torch.cuda.synchronize()
        forward_launches = _launched(fa)
        attention.set_attention_backend("xla")
        try:
            out_p = pm(x, t, c)
        finally:
            attention.set_attention_backend("auto")
        rel = ((out_k - out_p).norm() / out_p.norm()).item()
        res = {"phase": "sd15_f32_unet_vs_plain_attention", "dtype": str(out_k.dtype),
               "rel_l2_err": rel, "max_abs_err": (out_k - out_p).abs().max().item(),
               "tol": SD15_F32_REL_TOL, "finite": bool(torch.isfinite(out_k).all().item()),
               "k1_launches_by_variant": forward_launches}
        emit(res)
        if not (rel <= SD15_F32_REL_TOL and res["finite"]
                and forward_launches == SD15_F32_PER_FORWARD and out_k.dtype == torch.float32):
            raise RuntimeError(f"sd15_f32 forward check failed: {res}")

        forwards = [0]

        def counted(x, t, context=None, **kw):
            forwards[0] += 1
            return pm(x, t, context, **kw)

        stamps = []

        def on_step(i, latent):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run_sampler(counted, noise, ctx, sampler="dpmpp_2m", steps=SD15_F32_STEPS,
                          cfg_scale=SD_CFG, uncond_context=uctx, callback=on_step)
        torch.cuda.synchronize()
        launches = _launched(fa)
        step_s = [b - a for a, b in zip([start] + stamps[:-1], stamps)]
        want = {v: n * forwards[0] for v, n in SD15_F32_PER_FORWARD.items()}
        res = {"phase": "sd15_f32", "model": "sd15", "dtype": "float32",
               "n_params": unet.n_params(), "build_s": build_s, "steps": SD15_F32_STEPS,
               "cfg_scale": SD_CFG, "forwards": forwards[0], "s_per_it": sum(step_s) / len(step_s),
               "step_s": step_s, "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "k1_launches_by_variant": launches, "k1_launches_expected": want,
               "latent": list(out.shape), "finite": bool(torch.isfinite(out).all().item())}
        emit(res)
        if launches != want or not res["finite"] or res["latent"] != [1, 64, 64, 4]:
            raise RuntimeError(f"sd15_f32 check failed: {res}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return launches


CONTROLNET_STEPS = 10
# Per UNet forward: the base's 20 sm90 + 10 wide and the ControlNet trunk's 8 + 4
# (its input blocks; sd15_config() has no middle transformer).
SD15_CONTROLNET_PER_FORWARD = {"sm90": 28, "wide": 14}


def randomize_zero_convs(module, gen) -> None:
    """A ControlNet's zero convolutions (``ControlNet2D.zero_convs``) set to
    N(0, 1/fan_in): zero ones make an untrained ControlNet an exact no-op, which
    would hide what a check of it checks."""
    import torch

    with torch.no_grad():
        for conv in module.zero_convs():
            conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=gen)


def phase_sd15_controlnet() -> dict:
    """SD1.5 at full width with a ControlNet of the same config (the public
    ``control_v11p_sd15_*`` shape; zero convolutions random, not zero) at 512²:
    ``apply_control`` → ``parallelize`` → ``run_sampler`` dpmpp_2m/karras for
    ``CONTROLNET_STEPS`` steps at CFG ``SD_CFG``, exactly
    ``SD15_CONTROLNET_PER_FORWARD`` K1 launches per forward; one composed forward
    through K1 against plain attention; the residuals at strength 0.5 against 1.0;
    then a 9-channel inpaint UNet (``apply_inpaint_conditioning``), one forward
    with exactly ``SD15_PER_FORWARD`` launches against plain attention. Returns K1's
    launches by variant per path."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.controlnet import (
        apply_control,
        build_controlnet,
    )
    from comfyui_parallelanything_tpu_torch.models.unet import (
        apply_inpaint_conditioning,
        build_unet,
        sd15_config,
    )
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    t0 = time.perf_counter()
    unet = build_unet(sd15_config(), device=dev, generator=gen)
    cn = build_controlnet(sd15_config(), device=dev, generator=gen)
    randomize_zero_convs(cn.module, gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hint = torch.rand((1, 512, 512, 3), generator=gen, device=dev)
    composed = apply_control(unet, cn, hint)
    pm = parallelize(composed, [("cuda:0", 100)])
    forwards = [0]

    def counted(x, t, context=None, **kw):
        forwards[0] += 1
        return pm(x, t, context, **kw)

    noise = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    ctx = torch.randn((1, 77, 768), generator=gen, device=dev)
    uctx = torch.randn((1, 77, 768), generator=gen, device=dev)
    common = dict(cfg_scale=SD_CFG, uncond_context=uctx)
    run_sampler(counted, noise, ctx, sampler="euler", steps=1, **common)  # warm-up
    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    forwards[0] = 0
    fa.reset_launches()
    attention._RESOLVED.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = run_sampler(counted, noise, ctx, sampler="dpmpp_2m", karras=True,
                      steps=CONTROLNET_STEPS, callback=on_step, **common)
    torch.cuda.synchronize()
    launches = _launched(fa)
    step_s = [b - a for a, b in zip([start] + stamps[:-1], stamps)]
    want = {v: n * forwards[0] for v, n in SD15_CONTROLNET_PER_FORWARD.items()}
    res = {"phase": "sd15_controlnet", "model": "sd15+controlnet",
           "n_params": {"unet": unet.n_params(), "controlnet": cn.n_params()},
           "build_s": build_s, "steps": CONTROLNET_STEPS, "cfg_scale": SD_CFG,
           "forwards": forwards[0], "s_per_it": sum(step_s) / len(step_s), "step_s": step_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "k1_launches_by_variant": launches, "k1_launches_expected": want,
           "resolved_backends": list(attention.resolved_backends()),
           "latent": list(out.shape), "finite": bool(torch.isfinite(out).all().item())}
    emit(res)
    if (launches != want or forwards[0] != CONTROLNET_STEPS or not res["finite"]
            or res["latent"] != [1, 64, 64, 4] or res["resolved_backends"] != ["pallas"]):
        raise RuntimeError(f"sd15_controlnet check failed: {res}")

    # One composed forward (batch 2, as CFG runs it) through K1 and on plain
    # attention; the residuals at strength 0.5 against 1.0.
    x = torch.cat([noise, torch.randn((1, 64, 64, 4), generator=gen, device=dev)])
    t = torch.tensor([999.0, 999.0], device=dev)
    c = torch.cat([ctx, uctx])
    out_k = pm(x, t, c).float()
    attention.set_attention_backend("xla")
    try:
        out_p = pm(x, t, c).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    with torch.no_grad():
        full = composed.module.residuals(x, t, c)
        half = apply_control(unet, cn, hint, strength=0.5).module.residuals(x, t, c)
        out_half = apply_control(unet, cn, hint, strength=0.5)(x, t, c).float()
    flat = [torch.cat([r.float().flatten() for r in d["input"] + d["middle"]])
            for d in (full, half)]
    res_change = ((flat[0] - flat[1]).norm() / flat[0].norm()).item()
    out_change = ((out_k - out_half).norm() / out_k.norm()).item()
    res = {"phase": "sd15_controlnet_vs_plain_attention", "rel_l2_err": rel,
           "max_abs_err": (out_k - out_p).abs().max().item(), "tol": SD_REL_TOL,
           "finite": bool(torch.isfinite(out_k).all().item()),
           "residual_change_strength_1_to_0.5": res_change,
           "output_change_strength_1_to_0.5": out_change}
    emit(res)
    if not (rel <= SD_REL_TOL and res["finite"] and abs(res_change - 0.5) <= 1e-3
            and out_change > 0.0):
        raise RuntimeError(f"sd15_controlnet forward check failed: {res}")
    pm.cleanup()
    del pm, composed, cn, unet
    gc.collect()
    torch.cuda.empty_cache()

    # The 9-channel inpaint UNet: latent ‖ mask ‖ masked-image latent.
    unet9 = build_unet(sd15_config(in_channels=9), device=dev, generator=gen)
    mask = (torch.rand((1, 64, 64, 1), generator=gen, device=dev) > 0.5).float()
    masked = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    pm9 = parallelize(apply_inpaint_conditioning(unet9, mask, masked), [("cuda:0", 100)])
    pm9(x, t, c)  # warm-up, not counted
    fa.reset_launches()
    out_k = pm9(x, t, c).float()
    torch.cuda.synchronize()
    inpaint_launches = _launched(fa)
    attention.set_attention_backend("xla")
    try:
        out_p = pm9(x, t, c).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    res = {"phase": "sd15_inpaint_vs_plain_attention", "in_channels": 9, "rel_l2_err": rel,
           "max_abs_err": (out_k - out_p).abs().max().item(), "tol": SD_REL_TOL,
           "finite": bool(torch.isfinite(out_k).all().item()), "out": list(out_k.shape),
           "k1_launches_by_variant": inpaint_launches}
    emit(res)
    if not (rel <= SD_REL_TOL and res["finite"] and inpaint_launches == SD15_PER_FORWARD
            and res["out"] == [2, 64, 64, 4]):
        raise RuntimeError(f"sd15_inpaint forward check failed: {res}")
    pm9.cleanup()
    return {"sd15_controlnet": launches, "sd15_inpaint": inpaint_launches}


SD3_STEPS = 8  # cut from SD3.5-large's published 28 to keep the script in its time
SD3_CFG = 4.5
SD3_SHIFT = 3.0
SD3_T5_TOKENS = 77  # SAI's sd3_infer.py pads T5 to 77, so the context is 77 + 77 tokens
SD35L_SM90_PER_STEP = 38  # one joint attention a block, cond ‖ uncond in one call
SD35M_PER_FORWARD = {"sm90": 37}  # 24 joint + 13 x-only attentions


def phase_sd3() -> dict:
    """``Sd3Pipeline`` with SD3.5-large at full width and depth (38 blocks, hidden
    2432, 38 heads of 64, q/k RMS norm), CLIP-L, OpenCLIP-G, T5-XXL (77 tokens) and
    the SD3 VAE, random bf16 weights from a seeded generator, the MMDiT through
    ``parallelize``: 1024², batch 1, ``SD3_STEPS`` steps of flow_euler at shift
    ``SD3_SHIFT``, CFG ``SD3_CFG`` with a negative prompt; exactly
    ``SD35L_SM90_PER_STEP`` sm90 launches a step and one wide for the decode. Then one
    batch-2 MMDiT forward through K1 against plain attention, one step under the
    profiler, and SD3.5-medium's batch-2 forward (dual attention): exactly
    ``SD35M_PER_FORWARD``, against plain attention. Returns K1's launches by variant
    per path."""
    import copy

    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.mmdit import (
        build_mmdit,
        sd35_large_config,
        sd35_medium_config,
    )
    from comfyui_parallelanything_tpu_torch.models.text_encoders import (
        build_clip_text,
        build_t5_encoder,
        clip_l_config,
        open_clip_g_config,
        t5_xxl_config,
    )
    from comfyui_parallelanything_tpu_torch.models.vae import build_vae, sd3_vae_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.pipelines import Sd3Pipeline
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    cfg = sd35_large_config()
    dit = build_mmdit(cfg, device=dev, generator=gen)
    clip_l = build_clip_text(clip_l_config(), device=dev, generator=gen)
    clip_g = build_clip_text(open_clip_g_config(), device=dev, generator=gen)
    t5 = build_t5_encoder(t5_xxl_config(), device=dev, generator=gen)
    vae = build_vae(sd3_vae_config(), device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tok_l, t5_tok = synthetic_tokenizers(t5_len=SD3_T5_TOKENS)
    tok_g = copy.copy(tok_l)
    tok_g.pad_id = 0  # OpenCLIP-G pads with 0, CLIP-L with EOS
    pm = parallelize(dit, [("cuda:0", 100)])
    pipe = Sd3Pipeline(dit=pm, vae=vae, clip=clip_l, clip_g=clip_g, tokenizer=tok_l,
                       tokenizer_g=tok_g, t5=t5, t5_tokenizer=t5_tok)

    def nbytes(module):
        return sum(p.numel() * p.element_size() for p in module.parameters())

    spans: dict[str, float] = {}
    pipe.encode_prompt = _timed_span(spans, "encode_s", pipe.encode_prompt)
    vae.decode = _timed_span(spans, "decode_s", vae.decode)
    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    kw = dict(height=1024, width=1024, cfg_scale=SD3_CFG, shift=SD3_SHIFT)
    # Warm-up (encoders, MMDiT, VAE decoder), not counted: one step.
    pipe(PIPELINE_PROMPT, SD_NEGATIVE, steps=1, **kw)
    torch.cuda.synchronize()
    spans.clear()
    fa.reset_launches()
    attention._RESOLVED.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    img = pipe(PIPELINE_PROMPT, SD_NEGATIVE, steps=SD3_STEPS,
               rng=torch.Generator(device=dev).manual_seed(12), callback=on_step, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    launches = _launched(fa)
    resolved = list(attention.resolved_backends())
    step_s = [b - a for a, b in zip([spans["encode_s_end"]] + stamps[:-1], stamps)]
    res = {
        "phase": "sd3", "model": "sd3.5-large", "build_s": build_s,
        "n_params": {"mmdit": dit.n_params(),
                     "clip_l": sum(p.numel() for p in clip_l.module.parameters()),
                     "clip_g": sum(p.numel() for p in clip_g.module.parameters()),
                     "t5_xxl": sum(p.numel() for p in t5.module.parameters()),
                     "vae": sum(p.numel() for p in vae.module.parameters())},
        "weight_bytes": {"mmdit": nbytes(dit.module),
                         "mmdit_f32": sum(p.numel() * 4 for p in dit.module.parameters()
                                          if p.dtype == torch.float32),
                         "clip_l": nbytes(clip_l.module), "clip_g": nbytes(clip_g.module),
                         "t5_xxl": nbytes(t5.module), "vae": nbytes(vae.module)},
        "steps": SD3_STEPS, "cfg_scale": SD3_CFG, "shift": SD3_SHIFT,
        "context_tokens": 2 * SD3_T5_TOKENS, "total_s": total,
        "encode_s": spans["encode_s"], "denoise_s": sum(step_s), "decode_s": spans["decode_s"],
        "s_per_it": sum(step_s) / len(step_s), "step_s": step_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "k1_launches_by_variant": launches,
        "k1_launches_expected": {"sm90": SD35L_SM90_PER_STEP * SD3_STEPS, "wide": 1},
        "resolved_backends": resolved, "image": list(img.shape),
        "finite": bool(torch.isfinite(img).all().item()),
        "min": img.min().item(), "max": img.max().item(),
    }
    emit(res)
    if (launches != res["k1_launches_expected"] or resolved != ["pallas"]
            or res["image"] != [1, 1024, 1024, 3] or not res["finite"]
            or res["min"] < 0.0 or res["max"] > 1.0):
        raise RuntimeError(f"sd3 check failed: {res}")

    def forward_vs_plain(model, phase, want_launches):
        x = torch.randn((2, 128, 128, 16), generator=gen, device=dev)
        t = torch.tensor([0.75, 0.75], device=dev)
        ctx = torch.randn((2, 2 * SD3_T5_TOKENS, 4096), generator=gen, device=dev)
        y = torch.randn((2, 2048), generator=gen, device=dev)
        fa.reset_launches()
        out_k = model(x, t, ctx, y=y).float()
        torch.cuda.synchronize()
        forward_launches = _launched(fa)
        attention.set_attention_backend("xla")
        try:
            out_p = model(x, t, ctx, y=y).float()
        finally:
            attention.set_attention_backend("auto")
        rel = ((out_k - out_p).norm() / out_p.norm()).item()
        out = {"phase": phase, "rel_l2_err": rel,
               "max_abs_err": (out_k - out_p).abs().max().item(), "tol": SD_REL_TOL,
               "finite": bool(torch.isfinite(out_k).all().item()),
               "k1_launches_by_variant": forward_launches}
        emit(out)
        if not (rel <= SD_REL_TOL and out["finite"] and forward_launches == want_launches):
            raise RuntimeError(f"{phase} check failed: {out}")
        return forward_launches

    forward_vs_plain(pm, "sd35_large_vs_plain_attention", {"sm90": SD35L_SM90_PER_STEP})
    context, y1 = pipe.encode_prompt([PIPELINE_PROMPT])
    uctx, uy = pipe.encode_prompt([SD_NEGATIVE])
    noise = torch.randn((1, 128, 128, 16), generator=gen, device=dev)
    profile_step("sd3_profile", lambda: run_sampler(
        pm, noise, context, sampler="flow_euler", prediction="flow", steps=1,
        shift=SD3_SHIFT, cfg_scale=SD3_CFG, uncond_context=uctx, uncond_kwargs={"y": uy},
        y=y1))
    # The denoise captured against eager, in turns; its peak memory, the graph's pool
    # included, must stay below the card's.
    captured = captured_turns("sd3_captured", lambda c: run_sampler(
        pm, noise, context, sampler="flow_euler", prediction="flow", steps=SD3_STEPS,
        shift=SD3_SHIFT, cfg_scale=SD3_CFG, uncond_context=uctx, uncond_kwargs={"y": uy},
        y=y1, compile_loop=c), SD3_STEPS, {"sm90": SD35L_SM90_PER_STEP * SD3_STEPS})
    card = torch.cuda.get_device_properties(dev).total_memory
    peak = max([captured["capture_call_max_memory_allocated"]]
               + [r["max_memory_allocated"] for r in captured["runs"]])
    if not peak < card:
        raise RuntimeError(f"sd3 captured peak {peak} B is not below the card's {card} B")
    pm.cleanup()
    del pm, pipe, dit, clip_l, clip_g, t5, vae
    gc.collect()
    torch.cuda.empty_cache()

    medium = build_mmdit(sd35_medium_config(), device=dev, generator=gen)
    pm_m = parallelize(medium, [("cuda:0", 100)])
    medium_launches = forward_vs_plain(pm_m, "sd35_medium_vs_plain_attention",
                                       SD35M_PER_FORWARD)
    pm_m.cleanup()
    return {"sd3": launches, "sd3_captured": captured["k1_replayed_launches"],
            "sd35_medium": medium_launches}


HYBRID_CHAIN = [("cuda:0", 75), ("cpu", 25)]
HYBRID_BATCH = 4  # CFG makes every forward 8 rows
HYBRID_STEPS = 2
HYBRID_STEP_LIMIT_S = 30.0  # above this, one step of the host's share: one step only
HYBRID_REL_TOL = 5e-2  # per sample against the card alone: bf16 on two devices


def hybrid_split(pm, batch: int) -> tuple[int, ...]:
    """The rows of a ``batch``-row forward each platform group of ``pm`` takes."""
    from comfyui_parallelanything_tpu_torch.parallel.split import (
        largest_remainder_split,
        normalize_weights,
    )

    return largest_remainder_split(batch, normalize_weights([g.weight for g in pm._groups]))


class _row_trace:
    """Record, in call order, every leaf module's first input and output at batch
    row ``row`` (where their dim0 is the batch: with ``batch`` given, only outputs
    whose dim0 is exactly ``batch``) while the context is open."""

    def __init__(self, module, row: int, batch: int | None = None):
        self.module, self.row, self.calls, self.handles = module, row, [], []
        self.batch = batch

    def __enter__(self):
        import torch

        def record(name):
            def hook(m, args, out):
                x = args[0] if args and isinstance(args[0], torch.Tensor) else None
                if (isinstance(out, torch.Tensor) and out.ndim and out.shape[0] > self.row
                        and self.batch in (None, out.shape[0])):
                    self.calls.append((name, None if x is None or x.shape[0] != out.shape[0]
                                       else x[self.row].clone(), out[self.row].clone()))
            return hook

        self.handles = [m.register_forward_hook(record(n))
                        for n, m in self.module.named_modules() if not list(m.children())]
        return self.calls

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def _first_divergence(got: list, want: list) -> dict | None:
    """The first leaf-module call whose output row differs between two traced
    forwards, whether its input row already differed (then the difference came from
    an op between modules, e.g. the attention function), and both rows' relative L2."""
    import torch

    for (name, x_g, y_g), (_, x_w, y_w) in zip(got, want):
        if not torch.equal(y_g, y_w):
            same_in = x_g is not None and x_w is not None and torch.equal(x_g, x_w)
            return {"module": name, "input_equal": same_in, "rel_l2_out": rel_l2(y_g, y_w),
                    "rel_l2_in": None if same_in or x_g is None else rel_l2(x_g, x_w)}
    return None


def phase_hybrid(unet) -> dict:
    """The sd_samplers phase's SD1.5 UNet on a heterogeneous chain, ``HYBRID_CHAIN``
    with the default ``ParallelConfig``: 512², batch ``HYBRID_BATCH``, CFG ``SD_CFG``,
    euler for ``HYBRID_STEPS`` steps with ``compile_loop=True``, which must run the
    eager loop (no loop captured or replayed). The weights blended from the H100's
    and the host's roofline specs split each forward's rows; every sample within
    ``HYBRID_REL_TOL`` of the same run on ``[("cuda:0", 100)]``; K1 launched exactly
    ``SD15_PER_FORWARD`` per GPU-group forward and never for the host's rows (plain
    attention, bf16 on the host). The host's seconds per step come from hooks on its
    replica. Returns K1's launches by variant."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling import compiled
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    noise = torch.randn((HYBRID_BATCH, 64, 64, 4), generator=gen, device=dev)
    ctx, uctx = (torch.randn((HYBRID_BATCH, 77, 768), generator=gen, device=dev)
                 for _ in range(2))
    common = dict(sampler="euler", cfg_scale=SD_CFG, uncond_context=uctx)
    t0 = time.perf_counter()
    pm = parallelize(unet, HYBRID_CHAIN)
    place_s = time.perf_counter() - t0
    split = hybrid_split(pm, 2 * HYBRID_BATCH)
    host = pm._groups[1].replicas[0]
    host_s = []
    host.register_forward_pre_hook(lambda m, a: host_s.append(-time.perf_counter()))
    host.register_forward_hook(lambda m, a, o: host_s.append(host_s.pop() + time.perf_counter()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sampler(pm, noise, ctx, steps=1, **common)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    steps = HYBRID_STEPS if first_step_s <= HYBRID_STEP_LIMIT_S else 1
    want = run_sampler(parallelize(unet, [("cuda:0", 100)]), noise, ctx, steps=steps, **common)
    # The GPU group's rows of one CFG forward against the same rows of the 8-row
    # forward on the card alone: the same replica and inputs, only the batch differs.
    n_gpu = split[0]
    xr = torch.randn((2 * HYBRID_BATCH, 64, 64, 4), generator=gen, device=dev)
    tr = torch.full((2 * HYBRID_BATCH,), 500.0, device=dev)
    cr = torch.cat([ctx, uctx])
    gpu_replica = pm._groups[0].replicas[0]
    with torch.no_grad(), _row_trace(gpu_replica, n_gpu - 1) as calls_full:
        full = gpu_replica(xr, tr, cr)
    with torch.no_grad(), _row_trace(gpu_replica, n_gpu - 1) as calls_part:
        part = gpu_replica(xr[:n_gpu], tr[:n_gpu], cr[:n_gpu])
    rows = {"phase": "hybrid_rows", "gpu_rows": n_gpu,
            "rel_l2_per_row": [rel_l2(part[i], full[i]) for i in range(n_gpu)],
            "bitwise_equal_per_row": [bool(torch.equal(part[i], full[i])) for i in range(n_gpu)],
            "last_row_first_divergence": _first_divergence(calls_part, calls_full)}
    del calls_full, calls_part
    emit(rows)
    loops = compiled.loop_records()
    fa.reset_launches()
    host_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run_sampler(pm, noise, ctx, steps=steps, compile_loop=True, **common)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launched(fa)
    res = {
        "phase": "hybrid", "model": "sd15", "chain": HYBRID_CHAIN, "devices": list(pm.devices),
        "weights": list(pm.weights), "group_weights": [g.weight for g in pm._groups],
        "rows_per_forward": list(split), "batch": HYBRID_BATCH, "cfg_scale": SD_CFG,
        "steps": steps, "first_step_s": first_step_s,
        "steps_cut_to_one": steps != HYBRID_STEPS, "place_s": place_s,
        "s_per_it": seconds / steps, "host_group_s_per_step": host_s,
        "ran_eager": compiled.loop_records() == loops,
        "rel_l2_per_sample": [rel_l2(got[i], want[i]) for i in range(HYBRID_BATCH)],
        "tol": HYBRID_REL_TOL, "finite": bool(torch.isfinite(got).all().item()),
        "k1_launches_by_variant": launches,
        "k1_launches_expected": {v: n * steps for v, n in SD15_PER_FORWARD.items()},
    }
    emit(res)
    if not (res["ran_eager"] and res["finite"] and launches == res["k1_launches_expected"]
            and len(split) == 2 and split[0] >= 1 and split[1] >= 1 and len(host_s) == steps
            and max(res["rel_l2_per_sample"]) <= HYBRID_REL_TOL and got.device == dev):
        raise RuntimeError(f"hybrid check failed: {res}")
    pm.cleanup()
    return launches


# -- pipeline placement (batch 1 over cuda:0 + cpu) and the checkpoint path ---------

PIPE_CHAIN = [("cuda:0", 97), ("cpu", 3)]
PIPE_STEPS = 4
PIPE_STEP_LIMIT_S = 30.0  # above this, one step: the host's block sets each step
PIPE_REL_TOL = 5e-2  # against the card alone: one block in bf16 on the host's kernels
MULTI_GPU_REL_TOL = 1e-3  # every block on a card: the same kernels, other devices
LORA_RANK = 16
LORA_REL_TOL = 2e-2  # baked (f32 merge, one bf16 rounding) against W + B·A in bf16


def _flux_inputs(cfg, batch: int, seed: int):
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((batch, 128, 128, 16), generator=gen, device=dev),
            torch.randn((batch, 512, cfg.context_in_dim), generator=gen, device=dev),
            torch.randn((batch, cfg.vec_in_dim), generator=gen, device=dev))


class _HopClock:
    """Wraps a runner's ``_hop``: every hop that changes device, timed between two
    synchronisations, so a hop's seconds are its copy's alone."""

    def __init__(self, runner):
        import torch

        self.seconds = {"to_cpu": [], "to_cuda": []}
        hop = runner._hop

        def timed(carry, device):
            src = next(v.device for v in carry.values() if isinstance(v, torch.Tensor))
            if src == device:
                return hop(carry, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hop(carry, device)
            torch.cuda.synchronize()
            self.seconds["to_cpu" if device.type == "cpu" else "to_cuda"].append(
                time.perf_counter() - t0)
            return out

        runner._hop = timed


def _stage_hooks(stage) -> list:
    """Seconds of each forward of the stage's own blocks, summed per call of the
    first block's pre-hook to the last block's hook."""
    spans: list[float] = []
    s, e = stage.range
    blocks = [stage.module.double_blocks[i] if i < len(stage.module.double_blocks)
              else stage.module.single_blocks[i - len(stage.module.double_blocks)]
              for i in range(s, e)]
    blocks[0].register_forward_pre_hook(lambda m, a: spans.append(-time.perf_counter()))
    blocks[-1].register_forward_hook(
        lambda m, a, o: spans.append(spans.pop() + time.perf_counter()))
    return spans


def phase_pipeline_placement(pm) -> dict:
    """The main path's FLUX-dev over ``PIPE_CHAIN`` with the default
    ``ParallelConfig``: the blended weights give the host one of the 57 segments (the
    last single block), so batch-1 sampling (1024², ``flow_euler_sample``, guidance
    3.5) places the blocks as a pipeline: 56 ``sm90`` a step on the card, the host's
    block in bf16 on plain attention. ``PIPE_STEPS`` steps, or one when the first
    exceeds ``PIPE_STEP_LIMIT_S``; the latent within ``PIPE_REL_TOL`` of the same
    steps on the card alone; the host stage's and each hop's seconds, the seconds to
    place the stages, peak device memory. Then one batch-2 step with
    ``pipeline_microbatches=2`` (2 × 56 ``sm90``) against a batch-2 step on the card
    alone, and, where the machine has more than one card, batch 1 over every card.
    Returns K1's launches by path."""
    import torch

    from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.flow import flow_euler_sample

    dev = torch.device("cuda", 0)
    cfg = pm.model_config
    n_seg = cfg.depth + cfg.depth_single_blocks
    x, ctx, y = _flux_inputs(cfg, 1, 15)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pp = parallelize(pm, PIPE_CHAIN)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = pp._get_pipeline_runner()
    place_s = time.perf_counter() - t0
    ranges = [list(r) for r in runner.ranges]
    host = [st for st in runner.stages if st.range == runner.ranges[-1]]  # the "cpu" link's
    if runner.ranges[-1] != (n_seg - 1, n_seg) or len(host) != 1 \
            or host[0].device.type != "cpu":
        raise RuntimeError(f"expected the host to hold the last segment: {ranges}")
    hops = _HopClock(runner)
    host_s = _stage_hooks(host[0])
    sample = lambda model, steps, xs=(x, ctx, y): flow_euler_sample(  # noqa: E731
        model, xs[0], xs[1], steps=steps, guidance=3.5, y=xs[2])
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample(pp, 1)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    steps = PIPE_STEPS if first_step_s <= PIPE_STEP_LIMIT_S else 1
    want = sample(parallelize(pm, [("cuda:0", 100)]), steps)
    host_s.clear()
    for spans in hops.seconds.values():
        spans.clear()
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sample(pp, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launched(fa)
    res = {
        "phase": "pipeline_placement", "model": "flux-dev", "chain": PIPE_CHAIN,
        "weights": list(pp.weights), "stage_ranges": ranges,
        "stage_devices": [str(st.device) for st in runner.stages],
        "host_segments": list(host[0].labels),
        "batch": 1, "steps": steps, "steps_cut_to_one": steps != PIPE_STEPS,
        "first_step_s": first_step_s, "parallelize_s": setup_s, "stage_place_s": place_s,
        "s_per_it": seconds / steps, "host_stage_s_per_step": host_s, "hop_s": hops.seconds,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "rel_l2_vs_card_alone": rel_l2(got, want), "tol": PIPE_REL_TOL,
        "finite": bool(torch.isfinite(got).all().item()),
        "k1_launches_by_variant": launches, "k1_launches_expected": {"sm90": (n_seg - 1) * steps},
    }
    emit(res)
    if not (res["finite"] and launches == res["k1_launches_expected"] and len(host_s) == steps
            and len(hops.seconds["to_cpu"]) == steps and res["rel_l2_vs_card_alone"] <= PIPE_REL_TOL
            and got.device == dev and tuple(got.shape) == tuple(x.shape)):
        raise RuntimeError(f"pipeline_placement check failed: {res}")
    paths = {"pipeline_placement": launches}

    pp.cleanup()  # frees its host replica before the next chain places one
    del pp, runner
    gc.collect()
    x2, ctx2, y2 = _flux_inputs(cfg, 2, 16)
    want2 = sample(parallelize(pm, [("cuda:0", 100)]), 1, (x2, ctx2, y2))
    mb = parallelize(pm, PIPE_CHAIN, ParallelConfig(pipeline_microbatches=2))
    mb_hops = _HopClock(mb._get_pipeline_runner())
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got2 = sample(mb, 1, (x2, ctx2, y2))
    torch.cuda.synchronize()
    mb_launches = _launched(fa)
    res = {"phase": "pipeline_placement_microbatch", "batch": 2, "microbatches": 2,
           "s_per_it": time.perf_counter() - t0, "stage_ranges": [
               list(r) for r in mb._pipeline_runner.ranges], "hop_s": mb_hops.seconds,
           "rel_l2_vs_card_alone": rel_l2(got2, want2), "tol": PIPE_REL_TOL,
           "finite": bool(torch.isfinite(got2).all().item()),
           "k1_launches_by_variant": mb_launches,
           "k1_launches_expected": {"sm90": 2 * (n_seg - 1)}}
    emit(res)
    if not (res["finite"] and mb_launches == res["k1_launches_expected"]
            and res["rel_l2_vs_card_alone"] <= PIPE_REL_TOL):
        raise RuntimeError(f"pipeline_placement_microbatch check failed: {res}")
    paths["pipeline_placement_microbatch"] = mb_launches
    mb.cleanup()
    del mb
    gc.collect()

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "multi_gpu_pipeline", "multi_gpu_pipeline": "skipped", "cards": cards})
        return paths
    chain = [(f"cuda:{i}", 100 / cards) for i in range(cards)]
    want = sample(parallelize(pm, [("cuda:0", 100)]), 1)
    multi = parallelize(pm, chain)
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sample(multi, 1)
    torch.cuda.synchronize()
    multi_launches = _launched(fa)
    res = {"phase": "multi_gpu_pipeline", "cards": cards, "chain": chain,
           "stage_ranges": [list(r) for r in multi._pipeline_runner.ranges],
           "s_per_it": time.perf_counter() - t0, "rel_l2_vs_one_card": rel_l2(got, want),
           "tol": MULTI_GPU_REL_TOL, "k1_launches_by_variant": multi_launches,
           "k1_launches_expected": {"sm90": n_seg}}
    emit(res)
    if not (multi_launches == res["k1_launches_expected"]
            and res["rel_l2_vs_one_card"] <= MULTI_GPU_REL_TOL):
        raise RuntimeError(f"multi_gpu_pipeline check failed: {res}")
    paths["multi_gpu_pipeline"] = multi_launches
    multi.cleanup()
    return paths


STREAM_CHAIN = [("cuda:0", 100)]
STREAM_BUDGET = 8 * 2**30  # device bytes: FLUX-dev's 30.3 GB cannot be placed
STREAM_STEPS = 4
STREAM_B4_STEPS = 2
STREAM_INT8_STEPS = 2
STREAM_REL_TOL = 1e-3  # a streamed latent against its resident run, where not bitwise
PINNED_SLACK = 0.10  # page-locked host bytes over streamed bytes
# Device bytes a streamed call may hold beyond two slots and its resident run's
# activations: its small tensors (timesteps, guidance, the carry between stages)
# differ from the resident call's by about 1 MiB either way on FLUX-dev. A ring
# that grew would add a whole stage (0.34 GB or more).
STREAM_PEAK_SLACK = 32 * 2**20
H2D_PROBE_BYTES = 2**30


def host_rss_bytes() -> int:
    """This process's resident host memory (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS line in /proc/self/status")


def copy_gbs(src, dst, reps: int = 3) -> list[float]:
    """GB/s of ``reps`` host→device copies of the pinned ``src`` into ``dst``, each
    timed with CUDA events, after a warm-up copy."""
    import torch

    dst = dst[:src.numel()]
    dst.copy_(src, non_blocking=True)
    rates = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        rates.append(src.numel() / (a.elapsed_time(b) / 1e3) / 1e9)
    return rates


def h2d_gbs(dev) -> list[float]:
    """GB/s of a pinned host→device copy of ``H2D_PROBE_BYTES`` (a power of two, so
    the pinned allocator wastes nothing), three times."""
    import torch

    src = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    return copy_gbs(src, torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev))


def master_gbs(runner, dev) -> dict[str, list[float]]:
    """GB/s of copies of one largest stage's bytes from the start, the middle and the
    end of the runner's pinned master copy: the rate its stage copies can reach."""
    import torch

    buf, n = runner._master.host.buffer, runner.max_stage_nbytes
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    return {f"{off / 2**30:.1f} GiB": copy_gbs(buf[off:off + n], dst)
            for off in (0, (buf.numel() - n) // 2, buf.numel() - n)}


def _timed_sample(model, xs, steps: int):
    """``flow_euler_sample`` (guidance 3.5) over ``xs`` = (x, ctx, y), a synchronise
    after each step, with the peak device memory and K1's launches reset first.
    Returns (latent, seconds per step, peak device bytes, launches by variant, device
    bytes allocated when the run began)."""
    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.flow import flow_euler_sample

    stamps: list[float] = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_launches()
    start = time.perf_counter()
    latent = flow_euler_sample(model, xs[0], xs[1], steps=steps, guidance=3.5, y=xs[2],
                               callback=on_step)
    torch.cuda.synchronize()
    step_s = [b - a for a, b in zip([start] + stamps[:-1], stamps)]
    return latent, step_s, torch.cuda.max_memory_allocated(), _launched(fa), base


def _union_ms(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def stream_profile(phase: str, step) -> dict:
    """``step()`` under ``torch.profiler``, read for the stream's overlap: each
    host→device copy of at least 1 MiB (the stage copies) with its ms and GB/s, the
    idle gaps between consecutive ones, the kernel time, and how much of the copy
    time kernels ran beside (from the trace's ``gpu_memcpy`` and ``kernel``
    events, in µs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = trace_events(prof)
    copies = sorted((e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                     and e.get("args", {}).get("bytes", 0) >= 2**20), key=lambda e: e["ts"])
    kernels = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    beside = sum(max(0.0, min(c["ts"] + c["dur"], b) - max(c["ts"], a))
                 for c in copies for a, b in kernels)
    copy_ms = [c["dur"] / 1e3 for c in copies]
    result = {
        "phase": phase, "step_wall_s": wall_s, "copies": len(copies),
        "copy_ms": copy_ms, "copy_gbs": [c["args"]["bytes"] / (c["dur"] * 1e3) for c in copies],
        "copy_total_ms": sum(copy_ms),
        "gaps_ms": [(b["ts"] - a["ts"] - a["dur"]) / 1e3 for a, b in zip(copies, copies[1:])],
        "first_copy_at_ms": (copies[0]["ts"] - min(e["ts"] for e in events if e.get("cat") in (
            "kernel", "gpu_memcpy"))) / 1e3 if copies else None,
        "kernel_busy_ms": sum(b - a for a, b in kernels) / 1e3,
        "kernels_beside_copies_ms": beside / 1e3,
    }
    emit(result)
    return result


def stream_traced(runner, step, profiled: dict, want_launches: dict) -> dict:
    """One streamed step with the tracer on, inside a ``hardware_trace`` window,
    against an untraced step just before it: one ``stream-run``, one
    ``stream-stage-prefetch`` and one ``stream-stage-compute`` a stage; each stage's
    prefetch span (CUDA events on the copy stream) against the profiler's copy of
    that stage, and its compute span against the extent of the kernels launched
    inside the stage's profiler range, within max(10 %, 0.5 ms); the overlap
    efficiency (the spans' and ``pa_stream_overlap_efficiency``) against the same
    ratio from the profiler's intervals (stage kernel extents over the call's device
    extent) within 0.05; the traced latent bitwise the untraced one, and K1's
    launches those of an untraced step."""
    import tempfile

    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.utils import tracing
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    torch.cuda.synchronize()
    untraced = step()
    torch.cuda.synchronize()
    tracing.enable()
    try:
        with tempfile.TemporaryDirectory() as d:
            fa.reset_launches()
            t0 = time.perf_counter()
            with tracing.hardware_trace(d):
                traced = step()
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = _launched(fa)
            events = _chrome_events(tracing.tracer.hardware_traces[-1])
        xs = [e for e in tracing.export()["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "stream"]
        gauge = registry.get("pa_stream_overlap_efficiency", {"device": str(runner.device)})
    finally:
        tracing.disable()
        tracing.tracer.clear()
    n = runner.n_stages

    def by_stage(name):
        return sorted((e for e in xs if e["name"] == name), key=lambda e: e["args"]["stage"])

    runs, pre, comp = [e for e in xs if e["name"] == "stream-run"], by_stage(
        "stream-stage-prefetch"), by_stage("stream-stage-compute")
    copies = sorted((e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                     and e.get("args", {}).get("bytes", 0) >= 2**20), key=lambda e: e["ts"])
    stage_windows = _annotations(events, "stream-stage-compute")
    extents = []
    for acts in _launched_in(events, stage_windows):
        kern = [a for a in acts if a.get("cat") == "kernel"]
        extents.append((min(a["ts"] for a in kern), max(a["ts"] + a["dur"] for a in kern))
                       if kern else None)
    [run_window] = _annotations(events, "stream-run") or [None]
    call_acts = _launched_in(events, [run_window])[0] if run_window else []
    call_acts += copies
    call_us = (max(a["ts"] + a["dur"] for a in call_acts) - min(a["ts"] for a in call_acts)
               if call_acts else None)
    stages = []
    for k in range(n):
        p_us = pre[k]["dur"] if k < len(pre) else None
        c_us = comp[k]["dur"] if k < len(comp) else None
        copy_us = copies[k]["dur"] if k < len(copies) else None
        ext_us = extents[k][1] - extents[k][0] if k < len(extents) and extents[k] else None
        stages.append({
            "stage": k, "prefetch_span_ms": p_us and p_us / 1e3,
            "profiler_copy_ms": copy_us and copy_us / 1e3,
            "compute_span_ms": c_us and c_us / 1e3,
            "profiler_kernel_extent_ms": ext_us and ext_us / 1e3,
            "prefetch_ok": None not in (p_us, copy_us) and _agree(
                p_us, copy_us, STREAM_SPAN_REL, SPAN_VS_PROFILER_MS),
            "compute_ok": None not in (c_us, ext_us) and _agree(
                c_us, ext_us, STREAM_SPAN_REL, SPAN_VS_PROFILER_MS)})
    span_eff = tracing.stream_overlap_efficiency(xs)
    prof_eff = (sum(e[1] - e[0] for e in extents if e) / call_us) if call_us else None
    row = {"phase": "stream_traced", "stages": n, "stream_runs": len(runs),
           "prefetch_spans": len(pre), "compute_spans": len(comp),
           "profiler_copies": len(copies), "profiler_stage_ranges": len(stage_windows),
           "per_stage": stages, "overlap_efficiency_spans": span_eff,
           "overlap_efficiency_gauge": gauge, "overlap_efficiency_profiler": prof_eff,
           "run_span_ms": runs[0]["dur"] / 1e3 if runs else None,
           "profiler_call_ms": call_us and call_us / 1e3,
           "stream_profile_copy_total_ms": profiled["copy_total_ms"],
           "stream_profile_kernel_busy_ms": profiled["kernel_busy_ms"],
           "traced_step_wall_s": wall_s, "untraced_step_wall_s": profiled["step_wall_s"],
           "bitwise_vs_untraced": bool(torch.equal(traced, untraced)),
           "k1_launches_by_variant": launches, "k1_launches_expected": want_launches}
    emit(row)
    if not (len(runs) == 1 and len(pre) == n and len(comp) == n and len(copies) == n
            and all(st["prefetch_ok"] and st["compute_ok"] for st in stages)
            and None not in (span_eff, prof_eff, gauge)
            and abs(span_eff - prof_eff) <= STREAM_EFF_TOL
            and abs(gauge - prof_eff) <= STREAM_EFF_TOL and row["bitwise_vs_untraced"]
            and launches == want_launches):
        raise RuntimeError(f"stream_traced check failed: {row}")
    return row


def _stream_carve(runner) -> dict:
    return {"n_stages": runner.n_stages,
            "stage_ranges": [list(st.range) for st in runner.stages],
            "stage_nbytes": [st.nbytes for st in runner.stages],
            "max_stage_nbytes": runner.max_stage_nbytes,
            "streamed_nbytes": runner.streamed_nbytes,
            "resident_bytes": runner.tracker.resident_bytes,
            "pinned_nbytes": runner.pinned_nbytes,
            "pinned_over_streamed": runner.pinned_nbytes / runner.streamed_nbytes}


def _stream_row(phase: str, runner, got, want, step_s, peak, base, activations, launches,
                expected, **extra) -> dict:
    """One streamed run's line: its s/it, peak, residency and launches, and its
    latent against the same steps of a resident run of the same weights.

    The two-stage check is on the device: the run's peak, less what the card held
    apart from the stream when it began (``base`` less the resident submodules and
    the ring, which persists between calls), the resident submodules, and the
    activations of the resident run of the same batch (its peak less its start), is
    the streamed weights' peak, held to two slots (two stages, each tensor at the host
    copy's ``HOST_ALIGN``) and ``STREAM_PEAK_SLACK``. The tracker's peak is the host's bookkeeping of the same
    schedule, two stages by construction."""
    import torch

    rel = rel_l2(got, want)
    slot = max(b - a for a, b in (st.span for st in runner.stages))
    held = runner.tracker.resident_bytes + sum(s.numel() for s in runner._ring or ())
    card_other = base - held
    return {"phase": phase, "s_per_it": sum(step_s) / len(step_s), "step_s": step_s,
            "max_memory_allocated": peak, "budget": STREAM_BUDGET,
            "card_other_bytes": card_other, "resident_activation_bytes": activations,
            "streamed_weight_peak_bytes": (peak - card_other - runner.tracker.resident_bytes
                                           - activations),
            "tracker_peak_bytes": runner.tracker.peak_bytes,
            "two_stage_bytes": 2 * runner.max_stage_nbytes, "two_slot_bytes": 2 * slot,
            "bitwise_vs_resident": bool(torch.equal(got, want)), "rel_l2_vs_resident": rel,
            "tol": STREAM_REL_TOL, "finite": bool(torch.isfinite(got).all().item()),
            "k1_launches_by_variant": launches, "k1_launches_expected": expected, **extra}


def _stream_ok(row: dict, hold_budget: bool = True) -> bool:
    return (row["finite"] and row["rel_l2_vs_resident"] <= STREAM_REL_TOL
            and row["k1_launches_by_variant"] == row["k1_launches_expected"]
            and row["tracker_peak_bytes"] <= row["two_stage_bytes"]
            and row["streamed_weight_peak_bytes"] <= row["two_slot_bytes"] + STREAM_PEAK_SLACK
            and (not hold_budget or row["max_memory_allocated"] <= STREAM_BUDGET))


def phase_stream(pm, ref) -> dict:
    """The main path's FLUX-dev streamed from the host through ``parallel/streaming.py``
    under ``ParallelConfig(hbm_budget_bytes=STREAM_BUDGET)`` on ``STREAM_CHAIN``: the
    default ``weight_sharding``, so the weights-don't-fit route decides. First
    resident batch-4 and batch-1 references on the card (the batch-1 one only for its
    activations' peak); then the weights move to the host, and
    the stream pins its master copy (the carve, the pinned bytes against the streamed
    ones, the host's resident memory before and after) beside one pinned 1 GiB
    host→device copy's rate. Runs: bf16 at batch 1, ``STREAM_STEPS`` steps on the
    main path's inputs against its latent and s/it and the bound max(resident s/it,
    streamed bytes / copy rate), then one step under ``torch.profiler``
    (``stream_profile``: the stage copies and what computed beside them) and one
    serialised step (the runner's ``overlap`` off) against the main path's first
    step; batch 4, ``STREAM_B4_STEPS`` steps against the resident reference (its
    peak beside the resident run's peak less its weights); int8
    (``quantize_module`` of the same FLUX-dev, built again from the main path's seed)
    resident and then streamed, ``STREAM_INT8_STEPS`` steps each. Each run: peak
    device memory (held to the budget at batch 1 and int8), the streamed weights'
    device peak and the tracker's peak against two stages (``_stream_row``), exactly
    57 ``sm90`` a forward, the latent bitwise or within ``STREAM_REL_TOL`` of its
    resident run. Then the numerics sentinel on a streamed step and a
    ``stream-prefetch-oom`` plan (``stream_sentinel``). Returns K1's launches by
    path."""
    import tempfile

    import torch

    from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize
    from comfyui_parallelanything_tpu_torch.models.flux import build_flux
    from comfyui_parallelanything_tpu_torch.models.loader import params_nbytes
    from comfyui_parallelanything_tpu_torch.models.quantize import quantize_module
    from comfyui_parallelanything_tpu_torch.sampling.flow import flow_euler_sample

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = pm.model_config
    per_fwd = cfg.depth + cfg.depth_single_blocks
    module = pm._module
    weight_bytes = params_nbytes(module)
    config = ParallelConfig(hbm_budget_bytes=STREAM_BUDGET)
    xs1 = (ref["x"], ref["ctx"], ref["y"])
    xs4 = _flux_inputs(cfg, 4, 17)
    sample = lambda model, xs, steps: flow_euler_sample(  # noqa: E731
        model, xs[0], xs[1], steps=steps, guidance=3.5, y=xs[2])

    resident = parallelize(pm, STREAM_CHAIN)
    want4, res4_s, res4_peak, _, res4_base = _timed_sample(resident, xs4, STREAM_B4_STEPS)
    _, _, res1_peak, _, res1_base = _timed_sample(resident, xs1, 1)  # batch 1's activations
    del resident
    gc.collect()  # the pipeline phases' host replicas
    t0 = time.perf_counter()
    module.to("cpu")
    to_host_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    card_bytes = torch.cuda.memory_allocated(dev)
    rates = h2d_gbs(dev)
    h2d = statistics.median(rates)
    rss_before = host_rss_bytes()
    sp = parallelize(pm, STREAM_CHAIN, config)
    t0 = time.perf_counter()
    runner = sp._get_streaming_runner()  # what the first call builds: the pinned master copy
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = sample(sp, xs1, 1)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    master = master_gbs(runner, dev)
    master_rate = statistics.median(r for rates in master.values() for r in rates)
    carve = {"phase": "stream_carve", "model": "flux-dev", "chain": STREAM_CHAIN,
             "budget": STREAM_BUDGET, "is_streaming": sp.is_streaming,
             "weight_bytes": weight_bytes, **_stream_carve(runner),
             "stage_cap": STREAM_BUDGET * 2 // 5, "to_host_s": to_host_s,
             "runner_build_s": build_s, "first_step_s": first_call_s,
             "card_bytes_after_move": card_bytes,
             "host_rss_before_pin": rss_before, "host_rss_after_pin": host_rss_bytes(),
             "h2d_gbs": rates, "h2d_gbs_median": h2d, "master_gbs": master,
             "master_gbs_median": master_rate,
             "first_step_rel_l2_vs_resident": rel_l2(warm, ref["latent_1"])}
    emit(carve)
    if not (sp.is_streaming and carve["pinned_over_streamed"] <= 1 + PINNED_SLACK
            and carve["pinned_over_streamed"] >= 1):
        raise RuntimeError(f"stream_carve check failed: {carve}")

    bound = max(ref["s_per_it"], runner.streamed_nbytes / (h2d * 1e9))
    act1 = res1_peak - res1_base
    got, step_s, peak, launches, base = _timed_sample(sp, xs1, STREAM_STEPS)
    b1 = _stream_row("stream_bf16", runner, got, ref["latent"], step_s, peak, base, act1,
                     launches, {"sm90": per_fwd * STREAM_STEPS}, batch=1, steps=STREAM_STEPS,
                     resident_s_per_it=ref["s_per_it"], h2d_gbs=h2d, bound_s_per_it=bound,
                     transfer_s_per_it=runner.streamed_nbytes / (h2d * 1e9),
                     master_gbs=master_rate,
                     bound_at_master_rate_s_per_it=max(
                         ref["s_per_it"], runner.streamed_nbytes / (master_rate * 1e9)))
    emit(b1)
    profiled = stream_profile("stream_profile", lambda: sample(sp, xs1, 1))
    traced = stream_traced(runner, lambda: sample(sp, xs1, 1), profiled, {"sm90": per_fwd})
    # The serialised step: the same runner with ``overlap`` off, which is what
    # ``ParallelConfig(stream_overlap=False)`` builds (a second wrap would pin the
    # 30 GB master copy again; tests/test_torch_cuda.py drives that route).
    runner.overlap = False
    got, step_s, peak, launches, base = _timed_sample(sp, xs1, 1)
    runner.overlap = True
    serial = _stream_row("stream_overlap_off", runner, got, ref["latent_1"], step_s, peak,
                         base, act1, launches, {"sm90": per_fwd}, batch=1, steps=1,
                         overlapped_s_per_it=b1["s_per_it"], h2d_gbs=h2d,
                         copy_s=runner.streamed_nbytes / (h2d * 1e9),
                         resident_s_per_it=ref["s_per_it"])
    emit(serial)
    got, step_s, peak, launches, base = _timed_sample(sp, xs4, STREAM_B4_STEPS)
    b4 = _stream_row("stream_bf16_b4", runner, got, want4, step_s, peak, base,
                     res4_peak - res4_base, launches,
                     {"sm90": per_fwd * STREAM_B4_STEPS}, batch=4, steps=STREAM_B4_STEPS,
                     resident_s_per_it=sum(res4_s) / len(res4_s), resident_step_s=res4_s,
                     four_resident_b1_s=4 * ref["s_per_it"],
                     resident_peak=res4_peak, resident_peak_less_weights=res4_peak - weight_bytes)
    emit(b4)
    with tempfile.TemporaryDirectory() as d:
        sentinel = stream_sentinel(sp, lambda: sample(sp, xs1, 1), ref["latent_1"], per_fwd, d)
    sp.cleanup()
    del sp, runner
    gc.collect()

    q = build_flux(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    quantize_module(q.module)
    int8_bytes = params_nbytes(q.module)
    want_q, resq_s, resq_peak, _, resq_base = _timed_sample(parallelize(q, STREAM_CHAIN), xs1,
                                                            STREAM_INT8_STEPS)
    q.module.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    sq = parallelize(q, STREAM_CHAIN, config)
    if not sq.is_streaming:
        raise RuntimeError(f"the int8 FLUX-dev ({int8_bytes} B) was placed, not streamed")
    sample(sq, xs1, 1)  # pins the int8 master copy
    got, step_s, peak, launches, base = _timed_sample(sq, xs1, STREAM_INT8_STEPS)
    int8 = _stream_row("stream_int8", sq._stream_runner, got, want_q, step_s, peak, base,
                       resq_peak - resq_base, launches,
                       {"sm90": per_fwd * STREAM_INT8_STEPS}, batch=1, steps=STREAM_INT8_STEPS,
                       weight_bytes=int8_bytes, resident_s_per_it=sum(resq_s) / len(resq_s),
                       resident_peak=resq_peak,
                       **_stream_carve(sq._stream_runner))
    emit(int8)
    sq.cleanup()
    del sq, q
    gc.collect()
    emit({"phase": "stream", "seconds": time.perf_counter() - t_phase})
    for row, hold in ((b1, True), (b4, False), (serial, True), (int8, True)):
        if not _stream_ok(row, hold):
            raise RuntimeError(f"{row['phase']} check failed: {row}")
    return {"stream_bf16": b1["k1_launches_by_variant"],
            "stream_traced": traced["k1_launches_by_variant"],
            "stream_overlap_off": serial["k1_launches_by_variant"],
            "stream_bf16_b4": b4["k1_launches_by_variant"],
            "stream_int8": int8["k1_launches_by_variant"], **sentinel}


def public_flux_state_dict(cfg, gen, device):
    """A FLUX state dict in the public BFL layout at ``cfg``'s full size, random from
    ``gen`` on ``device``: the block linears' weights in ``float8_e4m3fn`` (as the
    public fp8 files ship them), N(0, 1/fan_in) before the cast; the rest in bf16
    (biases N(0, 0.02²), QK-norm scales one)."""
    import torch

    from comfyui_parallelanything_tpu_torch.models.convert import flux_key_map
    from comfyui_parallelanything_tpu_torch.models.flux import FluxModel

    with torch.device("meta"):
        like = FluxModel(cfg).state_dict()
    sd = {}
    for dst, src in flux_key_map(cfg).items():
        shape = like[dst].shape
        if src.endswith(".scale"):
            sd[src] = torch.ones(shape, dtype=torch.bfloat16, device=device)
            continue
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
        if len(shape) == 2:
            t = t.mul_(shape[1] ** -0.5)
            if src.startswith(("double_blocks.", "single_blocks.")):
                t = t.to(torch.float8_e4m3fn)
        else:
            t = t.mul_(0.02)
        sd[src] = t
    return sd


def kohya_lora(sd, rank: int, gen, device):
    """A rank-``rank`` kohya LoRA (``lora_unet_…`` with ``lora_down``/``lora_up``/
    ``alpha``, bf16) over every block's qkv, proj, MLP, ``linear1`` and ``linear2``;
    each delta about 5 % of its weight's scale (alpha = rank: scale 1)."""
    import torch

    lora = {}
    for key, w in sd.items():
        if not (key.startswith(("double_blocks.", "single_blocks.")) and key.endswith(
                (".qkv.weight", ".proj.weight", "_mlp.0.weight", "_mlp.2.weight",
                 ".linear1.weight", ".linear2.weight"))):
            continue
        out_dim, in_dim = w.shape
        name = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        lora[f"{name}.lora_down.weight"] = torch.randn(
            (rank, in_dim), generator=gen, device=device).mul_(in_dim ** -0.5).bfloat16()
        lora[f"{name}.lora_up.weight"] = torch.randn(
            (out_dim, rank), generator=gen, device=device).mul_(0.05 * rank ** -0.5).bfloat16()
        lora[f"{name}.alpha"] = torch.tensor(float(rank))
    return lora


def phase_checkpoint() -> dict:
    """FLUX-dev from a state dict in the public layout (fp8 block weights, built on
    the card from a seeded generator) with a rank-16 kohya LoRA, through
    ``load_flux_checkpoint(..., lora=...)`` → ``parallelize([("cuda:0", 100)])`` →
    4 steps at batch 1, 1024²: 57 ``sm90`` a step, one forward within
    ``MAIN_PATH_REL_TOL`` of plain attention, and the baked model's latent within
    ``LORA_REL_TOL`` of ``run_sampler(..., lora=factors)`` on the unbaked model
    (the factors from ``extract_lora_factors`` with the converter's key map, so they
    reach every LoRA target). Runs after the main path's model is freed. Returns
    K1's launches by path."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.convert import bake_lora, flux_key_map
    from comfyui_parallelanything_tpu_torch.models.flux import flux_dev_config
    from comfyui_parallelanything_tpu_torch.models.loader import load_flux_checkpoint
    from comfyui_parallelanything_tpu_torch.models.lora import extract_lora_factors
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    dev = torch.device("cuda", 0)
    cfg = flux_dev_config()
    per_step = cfg.depth + cfg.depth_single_blocks
    gen = torch.Generator(device=dev).manual_seed(17)
    torch.cuda.reset_peak_memory_stats(dev)
    sd = public_flux_state_dict(cfg, gen, dev)
    lora = kohya_lora(sd, LORA_RANK, gen, dev)
    torch.cuda.synchronize()
    fp8_bytes = sum(t.numel() * t.element_size() for t in sd.values()
                    if t.dtype == torch.float8_e4m3fn)
    baked_view = bake_lora(sd, lora)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for key in baked_view.deltas:  # every merge once, each freed as it is made
        baked_view[key]
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    del baked_view
    t0 = time.perf_counter()
    model = load_flux_checkpoint(sd, cfg, lora=lora, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated(dev)
    pm = parallelize(model, [("cuda:0", 100)])
    x, ctx, y = _flux_inputs(cfg, 1, 18)
    kw = dict(sampler="flow_euler", steps=STEPS, guidance=3.5, y=y)
    run_sampler(pm, x, ctx, **dict(kw, steps=1))  # warm-up
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baked = run_sampler(pm, x, ctx, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launched(fa)
    t = torch.full((1,), 0.5, device=dev)
    g = torch.full((1,), 3.5, device=dev)
    out_k = pm(x, t, ctx, y=y, guidance=g).float()
    attention.set_attention_backend("xla")
    try:
        out_p = pm(x, t, ctx, y=y, guidance=g).float()
    finally:
        attention.set_attention_backend("auto")
    pm.cleanup()
    del pm, model
    gc.collect()
    torch.cuda.empty_cache()

    plain = load_flux_checkpoint(sd, cfg, device=dev)
    factors = extract_lora_factors(lora, plain.module,
                                   aliases={v: k for k, v in flux_key_map(cfg).items()})
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launches()
    runtime = run_sampler(parallelize(plain, [("cuda:0", 100)]), x, ctx, lora=factors, **kw)
    torch.cuda.synchronize()
    runtime_launches = _launched(fa)
    res = {
        "phase": "checkpoint", "model": "flux-dev", "fp8_bytes": fp8_bytes,
        "lora_rank": LORA_RANK, "lora_targets": len(factors),
        "lora_pairs": sum(k.endswith(".alpha") for k in lora),
        "bake_s": bake_s, "load_s": load_s, "load_max_memory_allocated": load_peak,
        "steps": STEPS, "s_per_it": seconds / STEPS,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "finite": bool(torch.isfinite(baked).all().item()),
        "rel_l2_vs_plain_attention": rel_l2(out_k, out_p), "plain_tol": MAIN_PATH_REL_TOL,
        "rel_l2_baked_vs_runtime_lora": rel_l2(baked, runtime), "lora_tol": LORA_REL_TOL,
        "k1_launches_by_variant": launches, "k1_runtime_lora_launches": runtime_launches,
        "k1_launches_expected": {"sm90": per_step * STEPS},
    }
    emit(res)
    if not (res["finite"] and launches == res["k1_launches_expected"]
            and runtime_launches == res["k1_launches_expected"]
            and res["lora_targets"] == res["lora_pairs"]
            and res["rel_l2_vs_plain_attention"] <= MAIN_PATH_REL_TOL
            and res["rel_l2_baked_vs_runtime_lora"] <= LORA_REL_TOL):
        raise RuntimeError(f"checkpoint check failed: {res}")
    del plain, factors, lora
    gc.collect()
    torch.cuda.empty_cache()
    return {"checkpoint": launches, "checkpoint_runtime_lora": runtime_launches}


# ---------------------------------------------------------------------------
# The graph phase's synthetic files: the port's modules written out in the public
# layouts its loaders read (inverses of its converters), written with the port's
# safetensors writer (``models.loader.save_safetensors``). Also used by the CPU
# graph tests.
# ---------------------------------------------------------------------------

class _KeyProbe(dict):
    """A state dict that holds every key: each read returns a one-element tensor
    holding the read's index, so a converter's output names the source key each
    parameter came from."""

    def __init__(self):
        super().__init__()
        self.read: list[str] = []

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        import torch

        self.read.append(key)
        return torch.tensor([float(len(self.read) - 1)])


def ldm_unet_layout(cfg, state: dict, convert=None) -> dict:
    """A UNet (or, with ``convert``, a ControlNet) state dict of the port in the ldm
    layout its converter reads: the converter run on a ``_KeyProbe`` maps each port
    parameter to its ldm name."""
    from comfyui_parallelanything_tpu_torch.models.convert_unet import (
        convert_sd_unet_checkpoint,
    )

    probe = _KeyProbe()
    names = (convert or convert_sd_unet_checkpoint)(probe, cfg)
    src = {k: probe.read[int(v.item())] for k, v in names.items()}
    missing = set(state) - set(src)
    if missing:
        raise RuntimeError(f"the converter does not produce {sorted(missing)[:4]}")
    return {src[k]: v for k, v in state.items()}


_VAE_LDM_RENAMES = [
    (r"^encoder\.down_(\d+)_block_(\d+)\.", r"encoder.down.\1.block.\2."),
    (r"^encoder\.down_(\d+)_downsample\.", r"encoder.down.\1.downsample."),
    (r"^decoder\.up_(\d+)_block_(\d+)\.", r"decoder.up.\1.block.\2."),
    (r"^decoder\.up_(\d+)_upsample\.", r"decoder.up.\1.upsample."),
    (r"\.mid_block_(\d)\.", r".mid.block_\1."),
    (r"\.mid_attn_1\.", r".mid.attn_1."),
]


def ldm_vae_layout(state: dict) -> dict:
    """An ``AutoencoderKL`` state dict of the port in the ldm layout."""
    import re

    out = {}
    for key, v in state.items():
        for pat, rep in _VAE_LDM_RENAMES:
            key = re.sub(pat, rep, key)
        out[key] = v
    return out


def hf_clip_layout(state: dict) -> dict:
    """A ``CLIPTextModel`` state dict of the port in the HF ``text_model.*`` layout."""
    import re

    table = [(r"^tok_emb\.weight$", "text_model.embeddings.token_embedding.weight"),
             (r"^pos_emb$", "text_model.embeddings.position_embedding.weight"),
             (r"^final_ln\.", "text_model.final_layer_norm."),
             (r"^text_proj\.weight$", "text_projection.weight")]
    layer = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
             "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    out = {}
    for key, v in state.items():
        m = re.match(r"^layers\.(\d+)\.(\w+)\.(weight|bias)$", key)
        if m:
            out[f"text_model.encoder.layers.{m[1]}.{layer[m[2]]}.{m[3]}"] = v
            continue
        for pat, rep in table:
            if re.match(pat, key):
                out[re.sub(pat, rep, key)] = v
                break
        else:
            raise KeyError(f"no HF CLIP name for {key}")
    return out


def check_round_trip(written: dict, convert, state: dict, what: str) -> None:
    """Converting the dict about to be written must give back ``state`` bitwise."""
    import torch

    got = convert(written)
    if set(got) != set(state):
        raise RuntimeError(f"{what}: the round trip changes the keys: "
                           f"{sorted(set(got) ^ set(state))[:4]}")
    for k, v in state.items():
        if not torch.equal(got[k].to(v.dtype).cpu(), v.cpu()):
            raise RuntimeError(f"{what}: the round trip changes {k}")


def write_clip_tables(directory) -> tuple[str, str]:
    """``vocab.json`` and ``merges.txt`` over ``synthetic_tokenizers``' vocab (the
    CLIP byte-BPE tables the graph's ``TPUCLIPLoader`` reads through its
    ``vocab_path`` + ``merges_path`` route). Returns their paths."""
    import os

    clip, _ = synthetic_tokenizers(t5_len=8)
    vocab_path = os.path.join(directory, "vocab.json")
    merges_path = os.path.join(directory, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(clip.vocab, f)
    ranked = sorted(clip.ranks, key=clip.ranks.get)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in ranked)
    return vocab_path, merges_path


def write_sd15_files(directory, unet, vae, clip, dtype=None) -> dict:
    """The SD1.5 graph's files: the checkpoint (``model.diffusion_model.*`` plus the
    bundled ``first_stage_model.*`` VAE, in the ldm layout) and the CLIP-L tower (HF
    layout), each held by a round trip through the port's converters before it is
    written; ``dtype`` casts floating tensors (None keeps each module's). Returns
    ``{"ckpt": path, "clip": path}``."""
    import os

    from comfyui_parallelanything_tpu_torch.models.convert_text import (
        convert_clip_text_checkpoint,
    )
    from comfyui_parallelanything_tpu_torch.models.loader import save_safetensors
    from comfyui_parallelanything_tpu_torch.models.convert_unet import (
        convert_sd_unet_checkpoint,
        strip_prefix,
    )
    from comfyui_parallelanything_tpu_torch.models.convert_vae import convert_vae_checkpoint

    def cast(sd):
        return {k: (v.to(dtype) if dtype is not None and v.is_floating_point() else v)
                for k, v in sd.items()}

    unet_state = cast(unet.module.state_dict())
    vae_state = cast(vae.module.state_dict())
    clip_state = cast(clip.module.state_dict())
    ckpt = {f"model.diffusion_model.{k}": v
            for k, v in ldm_unet_layout(unet.config, unet_state).items()}
    ckpt.update({f"first_stage_model.{k}": v for k, v in ldm_vae_layout(vae_state).items()})
    check_round_trip(ckpt, lambda sd: convert_sd_unet_checkpoint(strip_prefix(sd), unet.config),
                     unet_state, "unet")
    check_round_trip(ckpt, lambda sd: convert_vae_checkpoint(sd, vae.cfg), vae_state, "vae")
    clip_sd = hf_clip_layout(clip_state)
    check_round_trip(clip_sd, lambda sd: convert_clip_text_checkpoint(sd, clip.cfg),
                     clip_state, "clip")
    paths = {"ckpt": os.path.join(directory, "sd15.safetensors"),
             "clip": os.path.join(directory, "clip_l.safetensors")}
    save_safetensors(paths["ckpt"], ckpt)
    save_safetensors(paths["clip"], clip_sd)
    return paths


def write_upscaler_file(path, upscaler) -> None:
    """An ESRGAN model in the modern RRDBNet layout (the port's own names), held by a
    round trip through ``convert_upscale_checkpoint``."""
    from comfyui_parallelanything_tpu_torch.models.loader import save_safetensors
    from comfyui_parallelanything_tpu_torch.models.upscale import convert_upscale_checkpoint

    state = upscaler.module.state_dict()
    check_round_trip(state, lambda sd: convert_upscale_checkpoint(sd)[0], state, "esrgan")
    save_safetensors(path, state)


GRAPH_CHAIN_PCT = 100.0
GRAPH_REL_TOL = 1e-3  # the graph's latent against a direct run_sampler (predicted bitwise)
GRAPH_INT8_STEPS = 4
GRAPH_INT8_REL_TOL = 0.2  # int8 weights against bf16's, 4 steps (PERF.md, before the run)
GRAPH_INT8_BYTES = (0.45, 0.60)  # resident UNet weight bytes, int8 over bf16
# SD1.5's K1 calls at the shapes the graphs give it and no earlier phase checks:
# 1024² (the hi-res pass, CFG's batch 2), 512² at the txt2img graph's batch 8 with
# CFG in one batch (16), and the VAE's at batch 8. Each is held against the plain
# version and timed in this phase.
GRAPH_K1_SHAPES = {
    "sd15_self_16384_d40": ((2, 16384, 8, 40), (2, 16384, 8, 40), 10, 1),
    "sd15_self_4096_d80": ((2, 4096, 8, 80), (2, 4096, 8, 80), 20, 2),
    "sd15_self_1024_d160": ((2, 1024, 8, 160), (2, 1024, 8, 160), 50, 5),
    "sd15_cross_16384x77_d40": ((2, 16384, 8, 40), (2, 77, 8, 40), 20, 2),
    "sd15_cross_4096x77_d80": ((2, 4096, 8, 80), (2, 77, 8, 80), 50, 5),
    "sd15_cross_1024x77_d160": ((2, 1024, 8, 160), (2, 77, 8, 160), 50, 5),
    "sd15_b16_self_4096_d40": ((16, 4096, 8, 40), (16, 4096, 8, 40), 10, 1),
    "sd15_b16_self_1024_d80": ((16, 1024, 8, 80), (16, 1024, 8, 80), 20, 2),
    "sd15_b16_self_256_d160": ((16, 256, 8, 160), (16, 256, 8, 160), 50, 5),
    "sd15_b16_cross_4096x77_d40": ((16, 4096, 8, 40), (16, 77, 8, 40), 20, 2),
    "sd15_b16_cross_1024x77_d80": ((16, 1024, 8, 80), (16, 77, 8, 80), 50, 5),
    "sd15_b16_cross_256x77_d160": ((16, 256, 8, 160), (16, 77, 8, 160), 50, 5),
    "sd15_vae_512_b8_d512": ((8, 4096, 1, 512), (8, 4096, 1, 512), 10, 1),
    # The stock txt2img graph: 1024², batch 4 with CFG in one batch (8), the decode
    # at batch 4.
    "sd15_b8_self_16384_d40": ((8, 16384, 8, 40), (8, 16384, 8, 40), 5, 1),
    "sd15_b8_self_4096_d80": ((8, 4096, 8, 80), (8, 4096, 8, 80), 10, 1),
    "sd15_b8_self_1024_d160": ((8, 1024, 8, 160), (8, 1024, 8, 160), 20, 2),
    "sd15_b8_cross_16384x77_d40": ((8, 16384, 8, 40), (8, 77, 8, 40), 10, 1),
    "sd15_b8_cross_4096x77_d80": ((8, 4096, 8, 80), (8, 77, 8, 80), 20, 2),
    "sd15_b8_cross_1024x77_d160": ((8, 1024, 8, 160), (8, 77, 8, 160), 50, 5),
    "sd15_vae_1024_b4_d512": ((4, 16384, 1, 512), (4, 16384, 1, 512), 5, 1),
    # The outpaint graph: a 512×640 canvas (a 64×80 latent), batch 1 with CFG (2),
    # the VAE encode and decode at batch 1. 320 queries of D = 160 leave a ragged
    # tail.
    "sd15_op_self_5120_d40": ((2, 5120, 8, 40), (2, 5120, 8, 40), 20, 2),
    "sd15_op_self_1280_d80": ((2, 1280, 8, 80), (2, 1280, 8, 80), 50, 5),
    "sd15_op_self_320_d160": ((2, 320, 8, 160), (2, 320, 8, 160), 50, 5),
    "sd15_op_cross_5120x77_d40": ((2, 5120, 8, 40), (2, 77, 8, 40), 50, 5),
    "sd15_op_cross_1280x77_d80": ((2, 1280, 8, 80), (2, 77, 8, 80), 50, 5),
    "sd15_op_cross_320x77_d160": ((2, 320, 8, 160), (2, 77, 8, 160), 50, 5),
    "sd15_vae_op_b1_d512": ((1, 5120, 1, 512), (1, 5120, 1, 512), 20, 2),
}


def graph_k1_shapes(fa, shapes=None) -> dict:
    """K1 at ``shapes`` (default ``GRAPH_K1_SHAPES``; rows ``(q shape, k shape,
    iterations, plain iterations[, dtype])``, bf16 unless named), each through the
    variant the rule picks: the check against the plain version (``KERNEL_LIMITS``),
    then the timing row (K1, plain, SDPA, the bound, and K1 over back-to-back calls)."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    for name, (qshape, kshape, iters, plain_iters, *dtype) in (
            shapes or GRAPH_K1_SHAPES).items():
        q, k, v = make_case(qshape, kshape, dtype[0] if dtype else "bfloat16", "contiguous",
                            gen, dev)
        variant = fa.kernel_variant(q, k, v)
        # Above PLAIN_SLICE_BYTES the check runs per (batch, head) pair and the plain
        # version is timed on one batch element.
        sliced = plain_logit_bytes(qshape, kshape) > PLAIN_SLICE_BYTES
        res = kernel_error(fa.flash_attention(q, k, v), q, k, v)
        if not res["ok"]:
            raise RuntimeError(f"flash_attention disagrees with its plain version at {name}: "
                               f"{res}")
        row = time_variant(fa, variant, q, k, v, iters, plain_iters,
                           plain_batch=1 if sliced else None)
        row["loop_ms"] = loop_ms(lambda: fa._launch(q, k, v, q.shape[-1] ** -0.5, variant),
                                 iters)
        rows[name] = {**row, **res}
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def graph_world(directory) -> dict:
    """The graph phase's files, from seeded generators on the card: full-width SD1.5
    (``sd15_config()``, bf16) with its bundled kl-f8 VAE, CLIP-L, the CLIP tables and
    an ESRGAN x4 model in RealESRGAN_x4plus's layout (23 RRDBs, 64 features, growth
    32). Returns their paths."""
    import os

    import torch

    from comfyui_parallelanything_tpu_torch.models import (
        build_clip_text,
        build_unet,
        build_vae,
        clip_l_config,
        sd15_config,
        sd_vae_config,
    )
    from comfyui_parallelanything_tpu_torch.models.upscale import UpscaleConfig, build_upscaler

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(23)
    unet = build_unet(sd15_config(), device=dev, generator=gen)
    vae = build_vae(sd_vae_config(), device=dev, generator=gen)
    clip = build_clip_text(clip_l_config(), device=dev, generator=gen)
    paths = write_sd15_files(directory, unet, vae, clip)
    del unet, vae, clip
    paths["vocab"], paths["merges"] = write_clip_tables(directory)
    esrgan = build_upscaler(UpscaleConfig(nf=64, nb=23, gc=32, scale=4), device=dev,
                            generator=gen)
    paths["esrgan"] = os.path.join(directory, "RealESRGAN_x4plus.safetensors")
    write_upscaler_file(paths["esrgan"], esrgan)
    del esrgan
    torch.cuda.empty_cache()
    return paths


def graph_example(name: str, paths: dict) -> dict:
    """An ``examples/`` graph with only the file paths, the chain (one
    ``ParallelDevice`` ``cuda:0`` at 100) and the save node changed (removed: the
    CPU tests hold ``TPUSaveImage``); widths, batches, steps and samplers as
    shipped."""
    import os

    with open(os.path.join("examples", f"{name}.json")) as f:
        wf = json.load(f)
    wf["checkpoint"]["inputs"]["ckpt_path"] = paths["ckpt"]
    clip = wf["clip"]["inputs"]
    clip.pop("tokenizer_json")
    clip.update(encoder_path=paths["clip"], vocab_path=paths["vocab"],
                merges_path=paths["merges"])
    del wf["dev1"], wf["save"]
    wf["dev0"]["inputs"].update(device_id="cuda:0", percentage=GRAPH_CHAIN_PCT)
    wf["parallel"]["inputs"]["parallel_devices"] = ["dev0", 0]
    if "esrgan" in wf:
        wf["esrgan"]["inputs"]["ckpt_path"] = paths["esrgan"]
    return wf


def run_graph(wf: dict, cache, fa) -> dict:
    """One ``host.run_workflow`` on ``cuda:0``: each node's seconds (a synchronise
    before every clock read) and the device memory each node added (allocated bytes at
    the next node's start less at its own), the nodes served from ``cache`` (a
    ``WorkflowCache``, or a dict of pre-seeded outputs), the UNet's forwards (a global
    forward hook on ``UNet2D``), K1's launches (the counts set to 0 just before the
    run and read just after) and the peak device memory."""
    import torch

    from comfyui_parallelanything_tpu_torch.host import run_workflow
    from comfyui_parallelanything_tpu_torch.models.unet import UNet2D

    dev = torch.device("cuda", 0)
    seconds, added, cached, forwards = {}, {}, [], [0]
    clock = {"node": None, "t": 0.0, "bytes": 0}

    def on_node(nid):
        torch.cuda.synchronize()
        now, allocated = time.perf_counter(), torch.cuda.memory_allocated(dev)
        if clock["node"] is not None:
            seconds[clock["node"]] = now - clock["t"]
            added[clock["node"]] = allocated - clock["bytes"]
        clock.update(node=nid, t=now, bytes=allocated)

    def count(module, args, out):
        if isinstance(module, UNet2D):
            forwards[0] += 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    fa.reset_launches()
    try:
        results = run_workflow(wf, outputs=cache, on_node=on_node, on_cached=cached.extend)
        torch.cuda.synchronize()
        seconds[clock["node"]] = time.perf_counter() - clock["t"]
        added[clock["node"]] = torch.cuda.memory_allocated(dev) - clock["bytes"]
    finally:
        hook.remove()
    return {"results": results, "node_seconds": seconds, "node_added_bytes": added,
            "cached": cached,
            "unet_forwards": forwards[0], "launches": _launched(fa),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _graph_row(name: str, run: dict, steps: dict, want_launches: dict) -> dict:
    """The printed row of one graph run; raises when K1's launches are not exactly
    ``want_launches``."""
    sps = {node: run["node_seconds"][node] / n for node, n in steps.items()}
    row = {"phase": "graph", "run": name, "node_seconds": run["node_seconds"],
           "cached_nodes": run["cached"], "s_per_it": sps, "unet_forwards":
           run["unet_forwards"], "k1_launches_by_variant": run["launches"],
           "peak_gb": run["peak_gb"]}
    if run["launches"] != want_launches:
        emit(row)
        raise RuntimeError(f"{name}: K1 launched {run['launches']}, want {want_launches}")
    return row


def phase_graph(tmp) -> tuple[dict, dict]:
    """The port's graph host on the card at full width (``host.run_workflow`` on
    ``cuda:0``): ``workflow_sd15_txt2img`` (512², batch 8, 28 dpmpp_2m/karras steps,
    CFG 7.5), ``workflow_sd15_hiresfix`` (20 steps at 512², a 2× latent upscale, 14
    steps at 1024² with denoise 0.55, the decode at 1024², ESRGAN ×4 in 256 tiles)
    and the txt2img graph with ``quantize="int8"`` at ``GRAPH_INT8_STEPS`` steps, on
    ``graph_world``'s files (written to the directory ``tmp``). Each run prints its
    seconds per node, the samplers' s/it, peak memory and K1's launches, which must
    be exactly 20 ``sm90`` + 10 ``wide`` per UNet forward plus one ``wide`` per
    decode (``decode_maybe_tiled`` with tile 0 decodes whole: one mid-block
    attention). The txt2img latent is held against a direct ``run_sampler`` with
    the graph's model, conditioning and seeded noise (``GRAPH_REL_TOL``); the int8
    run's UNet bytes against bf16's (``GRAPH_INT8_BYTES``) and its latent against a
    direct bf16 run of the same steps (``GRAPH_INT8_REL_TOL``); the ESRGAN image must
    be 4× the decode. Before the graphs, K1 at the new shapes they give it
    (``GRAPH_K1_SHAPES``). Returns K1's launches by run and the files' paths."""
    import torch

    from comfyui_parallelanything_tpu_torch import nodes
    from comfyui_parallelanything_tpu_torch.host import WorkflowCache
    from comfyui_parallelanything_tpu_torch.models.quantize import param_bytes
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.k_samplers import broadcast_cond_batch
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    start = time.perf_counter()
    shapes = graph_k1_shapes(fa)
    emit({"phase": "graph", "k1_shapes": shapes})
    dev = torch.device("cuda", 0)
    per_forward = SD15_PER_FORWARD
    launches = {}
    t0 = time.perf_counter()
    paths = graph_world(tmp)
    world_s = time.perf_counter() - t0
    cache = WorkflowCache()

    wf = graph_example("workflow_sd15_txt2img", paths)
    steps = wf["sampler"]["inputs"]["steps"]
    run = run_graph(wf, cache, fa)
    res = run["results"]
    want = {v: n * steps for v, n in per_forward.items()}
    want["wide"] += 1  # the decode
    row = _graph_row("graph_txt2img", run, {"sampler": steps}, want)
    launches["graph_txt2img"] = run["launches"]
    # The same sampling through run_sampler directly, from the graph's own model,
    # conditioning and seed.
    inp = wf["sampler"]["inputs"]
    latent = res["latent"][0]["samples"]
    batch = latent.shape[0]
    pm = res["parallel"][0]
    pos, neg = res["positive"][0], res["negative"][0]

    def direct(model, n):
        noise = nodes.initial_noise(inp["seed"], latent.shape, dev)
        return run_sampler(
            model, noise, broadcast_cond_batch(pos["context"], batch),
            sampler=inp["sampler_name"], steps=n, cfg_scale=inp["cfg"],
            uncond_context=broadcast_cond_batch(neg["context"], batch),
            uncond_kwargs={"y": broadcast_cond_batch(neg["pooled"], batch)},
            rng=nodes.seed_generator(inp["seed"], dev), scheduler=inp["scheduler"],
            y=broadcast_cond_batch(pos["pooled"], batch))

    out = res["sampler"][0]["samples"]
    image = res["decode"][0]
    ref = direct(pm, steps)
    row.update(latent_shape=list(out.shape), image_shape=list(image.shape),
               latent_vs_direct_rel_l2=rel_l2(out, ref),
               latent_bitwise=bool(torch.equal(out, ref)),
               finite=bool(torch.isfinite(image).all().item()), world_s=world_s)
    del ref
    emit(row)
    if row["latent_vs_direct_rel_l2"] > GRAPH_REL_TOL or not row["finite"]:
        raise RuntimeError(f"graph_txt2img: {row}")
    ref_int8 = direct(pm, GRAPH_INT8_STEPS)
    bf16_bytes = param_bytes(pm._module)
    del pm, res, pos, neg, out, image

    wf = graph_example("workflow_sd15_hiresfix", paths)
    s1, s2 = wf["sampler"]["inputs"]["steps"], wf["hires_pass"]["inputs"]["steps"]
    run = run_graph(wf, cache, fa)
    res = run["results"]
    want = {v: n * (s1 + s2) for v, n in per_forward.items()}
    want["wide"] += 1
    row = _graph_row("graph_hiresfix", run, {"sampler": s1, "hires_pass": s2}, want)
    launches["graph_hiresfix"] = run["launches"]
    image, final = res["decode"][0], res["final_upscale"][0]
    row.update(hires_latent_shape=list(res["hires_pass"][0]["samples"].shape),
               image_shape=list(image.shape), final_shape=list(final.shape),
               finite=bool(torch.isfinite(final).all().item()))
    emit(row)
    side = 2 * wf["latent"]["inputs"]["width"]  # the 2× latent upscale, decoded
    if (tuple(final.shape) != (1, 4 * side, 4 * side, 3)
            or tuple(image.shape) != (1, side, side, 3) or not row["finite"]):
        raise RuntimeError(f"graph_hiresfix: {row}")
    # Nothing of the bf16 graphs may outlive their cache entries into the int8
    # run's peak: the int8 checkpoint node evicts them.
    del run, res, image, final

    wf = graph_example("workflow_sd15_txt2img", paths)
    wf["checkpoint"]["inputs"]["quantize"] = "int8"
    wf["sampler"]["inputs"]["steps"] = GRAPH_INT8_STEPS
    run = run_graph(wf, cache, fa)
    res = run["results"]
    want = {v: n * GRAPH_INT8_STEPS for v, n in per_forward.items()}
    want["wide"] += 1
    row = _graph_row("graph_int8", run, {"sampler": GRAPH_INT8_STEPS}, want)
    launches["graph_int8"] = run["launches"]
    qm = res["parallel"][0]
    out = res["sampler"][0]["samples"]
    row.update(unet_bytes=param_bytes(qm._module), bf16_unet_bytes=bf16_bytes,
               int8_bytes_ratio=param_bytes(qm._module) / bf16_bytes,
               int8_dtypes=sorted({str(p.dtype) for p in qm._module.parameters()}),
               latent_vs_bf16_rel_l2=rel_l2(out, ref_int8),
               finite=bool(torch.isfinite(res["decode"][0]).all().item()),
               seconds=time.perf_counter() - start)
    emit(row)
    lo, hi = GRAPH_INT8_BYTES
    if (not lo <= row["int8_bytes_ratio"] <= hi
            or row["latent_vs_bf16_rel_l2"] > GRAPH_INT8_REL_TOL or not row["finite"]):
        raise RuntimeError(f"graph_int8: {row}")
    for value in list(cache.results):
        cache.evict(value)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, paths

STOCK_CKPT = "v1-5-pruned-emaonly.safetensors"  # workflow_stock_sd15_txt2img's ckpt_name
FREEU_GROWTH_LIMIT = 0.01  # FreeU_V2's added device bytes over the UNet's
OUTPAINT_SOURCE = (1, 512, 512, 3)


def stock_models_dir(paths: dict, directory) -> str:
    """``$PA_MODELS_DIR`` for the stock loaders under ``directory``: the graph
    world's checkpoint with its CLIP-L bundled as ``cond_stage_model.transformer.*``
    (an SD1.5 single file's layout) at ``checkpoints/<STOCK_CKPT>``."""
    import os

    from comfyui_parallelanything_tpu_torch.models.loader import (
        load_safetensors,
        save_safetensors,
    )

    root = os.path.join(directory, "models")
    os.makedirs(os.path.join(root, "checkpoints"), exist_ok=True)
    sd = load_safetensors(paths["ckpt"])
    sd.update({f"cond_stage_model.transformer.{k}": v
               for k, v in load_safetensors(paths["clip"]).items()})
    save_safetensors(os.path.join(root, "checkpoints", STOCK_CKPT), sd)
    return root


def phase_graph_stock(paths: dict, directory) -> dict:
    """The stock-name shims on the card at full width (``host.run_workflow`` on
    ``cuda:0``, ``graph_world``'s files). ``workflow_stock_sd15_txt2img`` as shipped
    but its ``SaveImage``: ``CheckpointLoaderSimple`` on ``STOCK_CKPT`` under
    ``$PA_MODELS_DIR`` (the family sniffed, the bundled CLIP-L with the tables from
    ``PA_CLIP_VOCAB`` + ``PA_CLIP_MERGES``), ``FreeU_V2``, 20 dpmpp_2m/karras steps
    at 1024² and batch 4, CFG 7, the whole decode: exactly 20 ``sm90`` + 10 ``wide``
    per forward plus the decode's ``wide``; the latent against a direct
    ``run_sampler`` with the graph's FreeU model, conditioning and seed
    (``GRAPH_REL_TOL``); the device bytes the ``FreeU_V2`` node adds under
    ``FREEU_GROWTH_LIMIT`` of the UNet's. Then ``workflow_sd15_inpaint_outpaint``
    with ``graph_example``'s rewrite, its ``source`` pre-seeded with a seeded
    ``OUTPAINT_SOURCE`` image (and no mask), without the save: a finite (1, 512, 640,
    3) paste, bitwise the padded source where the pad mask is 0, and exactly 20
    ``sm90`` + 10 ``wide`` per forward plus one ``wide`` each for the VAE encode's
    and decode's mid-block attention. Returns K1's launches by run."""
    import os

    import torch

    from comfyui_parallelanything_tpu_torch import nodes
    from comfyui_parallelanything_tpu_torch.host import WorkflowCache
    from comfyui_parallelanything_tpu_torch.models.quantize import param_bytes
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.k_samplers import broadcast_cond_batch
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    launches = {}
    t0 = time.perf_counter()
    env = {"PA_MODELS_DIR": stock_models_dir(paths, directory),
           "PA_CLIP_VOCAB": paths["vocab"], "PA_CLIP_MERGES": paths["merges"]}
    bundle_s = time.perf_counter() - t0
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with open(os.path.join("examples", "workflow_stock_sd15_txt2img.json")) as f:
            wf = json.load(f)
        del wf["9"]  # SaveImage: the CPU tests hold it
        inp = wf["3"]["inputs"]
        steps = inp["steps"]
        run = run_graph(wf, WorkflowCache(), fa)
        res = run["results"]
        want = {v: n * steps for v, n in SD15_PER_FORWARD.items()}
        want["wide"] += 1  # the decode, whole
        row = _graph_row("graph_stock_txt2img", run, {"3": steps}, want)
        row["phase"] = "graph_stock"
        launches["graph_stock_txt2img"] = run["launches"]
        model, patched = res["4"][0], res["20"][0]
        unet_bytes = param_bytes(model.module)
        out, image = res["3"][0]["samples"], res["8"][0]
        batch = out.shape[0]
        pos, neg = res["6"][0], res["7"][0]
        noise = nodes.initial_noise(inp["seed"], out.shape, dev)
        ref = run_sampler(
            patched, noise, broadcast_cond_batch(pos["context"], batch),
            sampler=inp["sampler_name"], steps=steps, cfg_scale=inp["cfg"],
            uncond_context=broadcast_cond_batch(neg["context"], batch),
            uncond_kwargs={"y": broadcast_cond_batch(neg["pooled"], batch)},
            rng=nodes.seed_generator(inp["seed"], dev), scheduler=inp["scheduler"],
            y=broadcast_cond_batch(pos["pooled"], batch))
        shared = all(a.data_ptr() == b.data_ptr()
                     for a, b in zip(model.module.parameters(), patched.module.parameters()))
        row.update(family=model.source["family"], freeu=list(patched.config.freeu),
                   freeu_added_bytes=run["node_added_bytes"]["20"], unet_bytes=unet_bytes,
                   freeu_added_share=run["node_added_bytes"]["20"] / unet_bytes,
                   freeu_shares_parameters=shared, latent_shape=list(out.shape),
                   image_shape=list(image.shape), latent_vs_direct_rel_l2=rel_l2(out, ref),
                   latent_bitwise=bool(torch.equal(out, ref)),
                   finite=bool(torch.isfinite(image).all().item()), bundle_s=bundle_s)
        emit(row)
        side = wf["5"]["inputs"]["width"]
        if (row["latent_vs_direct_rel_l2"] > GRAPH_REL_TOL or not row["finite"]
                or row["freeu_added_share"] >= FREEU_GROWTH_LIMIT or not shared
                or tuple(image.shape) != (wf["5"]["inputs"]["batch_size"], side, side, 3)
                or row["family"] != "sd15" or model.config.freeu is not None):
            raise RuntimeError(f"graph_stock_txt2img: {row}")
        del run, res, model, patched, out, image, pos, neg, noise, ref
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    wf = graph_example("workflow_sd15_inpaint_outpaint", paths)
    gen = torch.Generator(device=dev).manual_seed(31)
    source = torch.rand(OUTPAINT_SOURCE, generator=gen, device=dev)
    steps = wf["sampler"]["inputs"]["steps"]
    run = run_graph(wf, {"source": (source, torch.zeros(OUTPAINT_SOURCE[:3], device=dev))},
                    fa)
    res = run["results"]
    want = {v: n * steps for v, n in SD15_PER_FORWARD.items()}
    want["wide"] += 2  # the VAE encode's and decode's mid-block attention
    row = _graph_row("graph_outpaint", run, {"sampler": steps}, want)
    row["phase"] = "graph_stock"
    launches["graph_outpaint"] = run["launches"]
    padded, mask = res["outpaint_pad"]
    out = res["paste_back"][0]
    keep = (mask == 0)[..., None].expand_as(out)
    pad = wf["outpaint_pad"]["inputs"]
    row.update(image_shape=list(out.shape), latent_shape=list(
        res["encode_inpaint"][0]["samples"].shape), kept_pixels=int(keep.sum().item()),
        kept_bitwise=bool(torch.equal(out[keep], padded[keep])),
        finite=bool(torch.isfinite(out).all().item()), seconds=time.perf_counter() - start)
    emit(row)
    want_shape = (1, OUTPAINT_SOURCE[1] + pad["top"] + pad["bottom"],
                  OUTPAINT_SOURCE[2] + pad["left"] + pad["right"], 3)
    if (tuple(out.shape) != want_shape or not row["finite"] or not row["kept_bitwise"]
            or row["kept_pixels"] == 0):
        raise RuntimeError(f"graph_outpaint: {row}")
    del run, res, padded, mask, out, keep, source
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The continuous-batching serving path (server.py → host.run_workflow → run_sampler →
# the scheduler → a step bucket → the per-lane step program → the UNet → K1).
SERVING_WORKERS = 4  # the scheduler's default lane width too
# (seed, sampler, steps): two prompts a sampler, steps 20 or 28, so the lanes' schedules
# are ragged and a bucket runs four samplers at once.
SERVING_PROMPTS = [(101, "euler", 20), (102, "dpmpp_2m", 28), (103, "euler_ancestral", 20),
                   (104, "heun", 28), (105, "euler", 28), (106, "dpmpp_2m", 20),
                   (107, "euler_ancestral", 28), (108, "heun", 20)]
# Two prompts' texts: one bucket serves both, in stacked cond rows.
SERVING_TEXT_B = "an old harbour town at dusk, oil painting, warm light"
# A lane's latent against its inline run. float32 (TF32 off): the lane's update math
# alone, SERVING_REL_TOL. bf16: a bf16 UNet's result for a sample depends on its row in
# the batch (8.9e-3 relative for one forward with its rows permuted; identical rows of
# one inline batch-4 run differ, and that run is 2.4e-2 from the batch-1 run after 20
# steps: PERF.md §6), so bf16 lanes are held at SD_REL_TOL, the bf16 forward tolerance.
SERVING_REL_TOL = 1e-3
SERVING_F32_STEPS = (6, 8)  # the float32 lanes' steps, ragged
SERVING_FLUX_STEPS = (4, 4, 3, 2)
SERVING_FLUX_REL_TOL = 5e-2  # FLUX-dev lanes at batch 4 against batch-1 inline runs, bf16
# K1 at the lanes' shapes: SD1.5 at 512² in a width-4 bucket with CFG (8 rows), in bf16
# and float32, the decode tail at width 4, and FLUX-dev at 1024² in a width-4 bucket.
SERVING_K1_SHAPES = {
    "sd15_w4_self_4096_d40": ((8, 4096, 8, 40), (8, 4096, 8, 40), 20, 2),
    "sd15_w4_self_1024_d80": ((8, 1024, 8, 80), (8, 1024, 8, 80), 50, 5),
    "sd15_w4_self_256_d160": ((8, 256, 8, 160), (8, 256, 8, 160), 50, 5),
    "sd15_w4_cross_4096x77_d40": ((8, 4096, 8, 40), (8, 77, 8, 40), 50, 5),
    "sd15_w4_cross_1024x77_d80": ((8, 1024, 8, 80), (8, 77, 8, 80), 50, 5),
    "sd15_w4_cross_256x77_d160": ((8, 256, 8, 160), (8, 77, 8, 160), 50, 5),
    "sd15_vae_512_b4_d512": ((4, 4096, 1, 512), (4, 4096, 1, 512), 20, 2),
    # The float32 lanes (TF32 off): tf32x3.
    "sd15_f32_w4_self_4096_d40": ((8, 4096, 8, 40), (8, 4096, 8, 40), 10, 1, "float32"),
    "sd15_f32_w4_self_1024_d80": ((8, 1024, 8, 80), (8, 1024, 8, 80), 20, 2, "float32"),
    "sd15_f32_w4_self_256_d160": ((8, 256, 8, 160), (8, 256, 8, 160), 50, 5, "float32"),
    "sd15_f32_w4_cross_4096x77_d40": ((8, 4096, 8, 40), (8, 77, 8, 40), 50, 5, "float32"),
    "sd15_f32_w4_cross_1024x77_d80": ((8, 1024, 8, 80), (8, 77, 8, 80), 50, 5, "float32"),
    "sd15_f32_w4_cross_256x77_d160": ((8, 256, 8, 160), (8, 77, 8, 160), 50, 5, "float32"),
}
SERVING_FLUX_K1_SHAPES = {
    "flux_w4_4608_d128": ((4, 4608, 24, 128), (4, 4608, 24, 128), 10, 1),
}


def _quantile(values, q: float) -> float:
    """Linear-interpolated quantile (0-100) of a list."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def _http(method: str, url: str, body=None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        payload = r.read()
        return json.loads(payload) if "json" in r.headers.get("Content-Type", "") else payload


def _png_size(png: bytes) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR."""
    import struct

    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError("not a PNG")
    return struct.unpack(">II", png[16:24])


def _serve_prompts(base: str, graphs: list, together: bool) -> dict:
    """POST ``graphs`` to the server at ``base`` (all at once, or each after the
    previous finished), wait for every history entry, fetch each image through
    ``/view``. Returns per-prompt latencies (POST to history), the wall, and the
    images' sizes."""
    posted, done, pids = {}, {}, []
    start = time.perf_counter()

    def post(wf):
        pid = _http("POST", f"{base}/prompt", {"prompt": wf})["prompt_id"]
        posted[pid] = time.perf_counter()
        pids.append(pid)
        return pid

    def wait(want):
        while not want <= set(done):
            hist = _http("GET", f"{base}/history")
            now = time.perf_counter()
            for pid in want:
                if pid in hist and pid not in done:
                    done[pid] = (now, hist[pid])
            time.sleep(0.02)

    if together:
        for wf in graphs:
            post(wf)
        wait(set(pids))
    else:
        for wf in graphs:
            wait({post(wf)})
    wall = time.perf_counter() - start
    sizes = []
    for pid in pids:
        entry = done[pid][1]
        if entry["status"]["status_str"] != "success":
            raise RuntimeError(f"serving: prompt {pid} failed: {entry['status']}")
        (out,) = entry["outputs"].values()
        (img,) = out["images"]
        png = _http("GET", f"{base}/view?filename={img['filename']}&subfolder={img['subfolder']}")
        sizes.append(_png_size(png))
    return {"wall_s": wall, "latency_s": [done[p][0] - posted[p] for p in pids],
            "image_sizes": sizes, "pids": pids}


def _serve_lanes(calls, width: int = 4, ordered: bool = False, raise_errors: bool = True
                 ) -> tuple:
    """Run ``calls`` (zero-argument ``run_sampler`` callables) as concurrent
    submitters on a width-``width`` scheduler pumped by hand, all queued before the
    first dispatch (``ordered``: each queued before the next starts, so call i sits
    in slot i). Returns (results in order, dispatches); with ``raise_errors`` off a
    call's exception is its result."""
    import threading

    from comfyui_parallelanything_tpu_torch.serving import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(max_width=width, auto=False).install()
    results: dict = {}

    def lane(i, call):
        try:
            results[i] = call()
        except BaseException as e:  # noqa: BLE001 - raised below, on this thread
            results[i] = e

    try:
        threads = [threading.Thread(target=lane, args=(i, c), daemon=True)
                   for i, c in enumerate(calls)]
        t0 = time.monotonic()
        for i, t in enumerate(threads):
            t.start()
            want = i + 1 if ordered else (len(calls) if i == len(calls) - 1 else 0)
            while sum(len(b.queue) for b in list(sched.buckets.values())) < want:
                if time.monotonic() - t0 > 120:
                    raise RuntimeError("serving: the lanes never queued")
                time.sleep(0.002)
        sched.drain(timeout=600)
        for t in threads:
            t.join(600)
        dispatches = sched.total_dispatches()
    finally:
        sched.shutdown()
    out = [results.get(i, RuntimeError("a lane never returned")) for i in range(len(calls))]
    for r in out:
        if isinstance(r, BaseException) and raise_errors:
            raise r
    return out, dispatches


def _row_bisect(model, latent_shape, ctx_dim: int) -> dict:
    """The ``_row_probe`` forward layer by layer: which rows of the permuted forward
    differ from the same samples in the original order, then, for the first that
    does, leaf-module hooks on the UNet record that sample's row in both forwards and
    the first module whose output row differs is named (``_first_divergence``); the
    same with ``torch.backends.cudnn.deterministic = True`` and ``benchmark =
    False``."""
    import torch

    module = getattr(model, "_module", None) or model.module
    dev = torch.device("cuda", 0)
    perm = [2, 3, 0, 1, 6, 7, 4, 5]
    out = {}
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        for name, det in (("default", False), ("cudnn_deterministic", True)):
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.benchmark = False if det else cudnn[1]
            g = torch.Generator(device=dev).manual_seed(21)
            x = torch.randn((8,) + tuple(latent_shape[1:]), generator=g, device=dev)
            t = torch.linspace(10.0, 990.0, 8, device=dev)
            c = torch.randn((8, 77, ctx_dim), generator=g, device=dev)
            p = torch.tensor(perm, device=dev)
            with torch.no_grad():
                a = model(x, t, c)
                b = model(x[p], t[p], c[p])
                per_row = [rel_l2(b[r], a[perm[r]]) for r in range(8)]
                row = next((r for r in range(8) if not torch.equal(b[r], a[perm[r]])), None)
                divergence = None
                if row is not None:
                    with _row_trace(module, perm[row], batch=8) as calls_a:
                        model(x, t, c)
                    with _row_trace(module, row, batch=8) as calls_b:
                        model(x[p], t[p], c[p])
                    divergence = _first_divergence(calls_b, calls_a)
                    del calls_a, calls_b
            out[name] = {"rows_permuted_bitwise": bool(torch.equal(b, a[p])),
                         "rows_permuted_rel_l2": rel_l2(b, a[p]),
                         "rel_l2_per_slot": per_row,
                         "traced_slot": row, "traced_sample": None if row is None else perm[row],
                         "first_divergence": divergence}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    return out


def _row_probe(model, latent_shape, ctx_dim: int) -> dict:
    """One 8-row forward against the same rows permuted: whether a row's result
    depends on where it sits in the batch."""
    import torch

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((8,) + tuple(latent_shape[1:]), generator=g, device=dev)
    t = torch.linspace(10.0, 990.0, 8, device=dev)
    c = torch.randn((8, 77, ctx_dim), generator=g, device=dev)
    perm = torch.tensor([2, 3, 0, 1, 6, 7, 4, 5], device=dev)
    with torch.no_grad():
        a, b = model(x, t, c), model(x[perm], t[perm], c[perm])
    return {"rows_permuted_bitwise": bool(torch.equal(b, a[perm])),
            "rows_permuted_rel_l2": rel_l2(b, a[perm])}


SERVING_TRACED_STEPS = 12  # the profiled lanes: 4 euler lanes, one width-4 dispatch a step
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")
SPAN_VS_PROFILER_REL = 0.05  # a dispatch span against its profiler window: max(5 %, 0.5 ms)
SPAN_VS_PROFILER_MS = 0.5
STREAM_SPAN_REL = 0.10  # a stream stage's device span against the profiler: max(10 %, 0.5 ms)
STREAM_EFF_TOL = 0.05  # the overlap efficiency against the profiler's intervals


def _chrome_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _launched_in(events: list[dict], windows: list[dict]) -> list[list[dict]]:
    """For each CPU window (a ``user_annotation`` event), the device activities
    (kernels and copies) whose runtime call lies inside it on its thread, joined
    through the profiler's correlation ids."""
    device = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "correlation" in e.get(
                "args", {}):
            device.setdefault(e["args"]["correlation"], []).append(e)
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})]
    out = []
    for w in windows:
        a, b = w["ts"], w["ts"] + w["dur"]
        out.append([d for c in calls if c.get("tid") == w.get("tid") and a <= c["ts"] <= b
                    for d in device.get(c["args"]["correlation"], ())])
    return out


def _annotations(events: list[dict], name: str) -> list[dict]:
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == name), key=lambda e: e["ts"])


def _agree(a_us: float, b_us: float, rel: float, floor_ms: float) -> bool:
    return abs(a_us - b_us) <= max(rel * abs(b_us), floor_ms * 1e3)


def _hist_delta(before: str, after: str, name: str) -> str:
    """The ``_bucket`` lines of histogram ``name`` in ``after`` less ``before``: the
    observations made between two scrapes."""
    def buckets(text):
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in text.splitlines() if ln.startswith(name + "_bucket")}

    b = buckets(before)
    return "\n".join(f"{k} {v - b.get(k, 0.0)}" for k, v in buckets(after).items()) + "\n"


def _counter_sum(text: str, name: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name + "{") or ln.startswith(name + " "))


def _nested(events: list[dict]) -> bool:
    """Whether X events on one tid nest (each inside or apart from the one above)."""
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-3:
                stack.pop()
            if stack and e["ts"] + e["dur"] > stack[-1]["ts"] + stack[-1]["dur"] + 1.0:
                return False
            stack.append(e)
    return True


def _serving_traced(server, stop, graphs, seeds, cache, fresh_samplers, directory) -> dict:
    """The ``serving`` phase's traced run: the same 8 prompts through a 4-worker server
    started with ``trace=True``, each prompt's timeline from ``GET /trace?prompt_id=``,
    the dispatch spans against ``pa_serving_dispatch_total``, the SLO stages; then
    width-4 dispatches through the scheduler in profiler windows with tracing on and
    off (the spans against the profiler, the device busy share, the synchronise
    calls per dispatch) and in turns without a profiler (the overhead)."""
    import os
    import threading

    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.k_samplers import broadcast_cond_batch
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler
    from comfyui_parallelanything_tpu_torch.serving import decode as decode_mod
    from comfyui_parallelanything_tpu_torch.serving.bucket import StepBucket
    from comfyui_parallelanything_tpu_torch.utils import metrics, slo, tracing
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    start = time.perf_counter()
    waits: dict = {}
    dispatch = decode_mod.DecodeQueue._dispatch

    def recording_dispatch(self, key, tickets):
        now = time.monotonic()
        for t in tickets:
            waits[t.prompt_id] = now - t.submit_ts  # the decode_wait stage's own sample
        return dispatch(self, key, tickets)

    srv, q, base = server(SERVING_WORKERS, trace=True)
    decode_mod.DecodeQueue._dispatch = recording_dispatch
    try:
        fresh_samplers()
        for nid in ("positive", "negative"):  # the encode stage runs again
            cache.evict(nid)
        tracing.enable()
        torch.cuda.synchronize()
        fa.reset_launches()
        text0 = registry.render()
        run = _serve_prompts(base, graphs, together=True)
        torch.cuda.synchronize()
        text1 = registry.render()
        launches = _launched(fa)
        timelines = {pid: _http("GET", f"{base}/trace?prompt_id={pid}") for pid in run["pids"]}
        whole = _http("GET", f"{base}/trace")
    finally:
        decode_mod.DecodeQueue._dispatch = dispatch
        stop(srv, q)
    dispatches = _counter_sum(text1, "pa_serving_dispatch_total") - _counter_sum(
        text0, "pa_serving_dispatch_total")
    decodes = _counter_sum(text1, "pa_decode_dispatch_total") - _counter_sum(
        text0, "pa_decode_dispatch_total")
    want = {v: c * int(dispatches) for v, c in SD15_PER_FORWARD.items()}
    want["wide"] += int(decodes)  # the decode's mid-block attention
    spans = [e for e in whole["traceEvents"] if e.get("ph") == "X"]
    n_dispatch_spans = sum(e["name"] == "serving-dispatch" for e in spans)
    need = {"prompt", "workflow-node", "sampler-run", "lane-wait", "lane", "step", "decode"}
    per_prompt, bad = {}, []
    for seed, pid in zip(seeds, run["pids"]):
        xs = [e for e in timelines[pid]["traceEvents"] if e.get("ph") == "X"]
        names = {e["name"] for e in xs}
        by_class: dict = {}
        for e in xs:
            if e["name"] == "workflow-node":
                ct = e["args"]["class_type"]
                by_class[ct] = by_class.get(ct, 0.0) + e["dur"] / 1e6
        prompt = next(e for e in xs if e["name"] == "prompt")
        row = {
            "spans": sorted(names), "n_steps": sum(e["name"] == "step" for e in xs),
            "admission_s": sum(e["dur"] for e in xs if e["name"] == "admission-wait") / 1e6,
            "encode_s": sum(v for k, v in by_class.items() if "TextEncode" in k),
            "lane_wait_s": sum(e["dur"] for e in xs if e["name"] == "lane-wait") / 1e6,
            "eval_s": sum(v for k, v in by_class.items() if "Sampler" in k),
            "decode_wait_s": waits.get(pid),
            "decode_s": sum(v for k, v in by_class.items() if "Decode" in k),
            "prompt_s": prompt["dur"] / 1e6,
            "uncovered_nodes_s": {k: v for k, v in by_class.items()
                                  if not any(m in k for m in ("TextEncode", "Sampler", "Decode"))},
        }
        row["request_s"] = row["admission_s"] + row["prompt_s"]
        covered = row["admission_s"] + row["encode_s"] + row["eval_s"] + row["decode_s"]
        row["uncovered_s"] = row["request_s"] - covered
        ok = (need <= names and _nested([e for e in xs if e["name"] != "admission-wait"])
              and row["lane_wait_s"] <= row["eval_s"]
              and row["decode_wait_s"] is not None and row["decode_wait_s"] <= row["decode_s"]
              and covered <= row["request_s"] + 1e-4)
        if not ok:
            bad.append(seed)
        per_prompt[str(seed)] = row
    stages = {}
    for stage in ("admission", "encode", "lane_wait", "eval", "decode_wait", "decode"):
        delta = _hist_delta(text0, text1, "pa_slo_stage_seconds")
        stages[stage] = {f"p{q}": slo.histogram_quantile(delta, "pa_slo_stage_seconds", q,
                                                         labels={"stage": stage})
                         for q in (50, 95)}
    delta = _hist_delta(text0, text1, "pa_slo_request_seconds")
    stages["request"] = {f"p{q}": slo.histogram_quantile(delta, "pa_slo_request_seconds", q)
                         for q in (50, 95)}
    # The same stages per request from the spans (exact, where the exposition's
    # quantiles interpolate inside bucket edges).
    span_stages = {k: {f"p{q}": _quantile([r[f"{k}_s"] for r in per_prompt.values()], q)
                       for q in (50, 95)}
                   for k in ("admission", "encode", "lane_wait", "eval", "decode_wait",
                             "decode", "request")
                   if all(r[f"{k}_s"] is not None for r in per_prompt.values())}
    row = {"phase": "serving_traced", "prompts": len(graphs), "dispatches": dispatches,
           "span_stage_quantiles_s": span_stages,
           "decode_dispatches": decodes, "k1_launches_by_variant": launches,
           "k1_launches_expected": want,
           "serving_dispatch_spans": n_dispatch_spans, "bad_timelines": bad,
           "slo_stage_quantiles_s": stages, "requests": per_prompt,
           "uncovered_mean_s": statistics.mean(r["uncovered_s"] for r in per_prompt.values()),
           "enabled": whole["enabled"], "host_id": whole["host_id"]}
    emit(row)
    if bad or n_dispatch_spans != dispatches or dispatches == 0 or launches != want:
        raise RuntimeError(f"serving_traced: timelines {bad} incomplete or not nested, or "
                           f"{n_dispatch_spans} dispatch spans for {dispatches} dispatches, "
                           f"or K1 launched {launches} (want {want})")

    # Width-4 dispatches through the scheduler: 4 euler lanes of SERVING_TRACED_STEPS.
    res = cache.results
    pm, pos, neg = res["parallel"][0], res["positive"][0], res["negative"][0]
    shape = tuple(res["latent"][0]["samples"].shape)
    dev = torch.device("cuda", 0)
    kw = dict(cfg_scale=7.5, uncond_context=broadcast_cond_batch(neg["context"], 1),
              uncond_kwargs={"y": broadcast_cond_batch(neg["pooled"], 1)},
              y=broadcast_cond_batch(pos["pooled"], 1))
    noises = [torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(300 + i),
                          device=dev) for i in range(4)]

    def lanes(steps=SERVING_TRACED_STEPS):
        # In order: lane i sits in slot i every time, so runs compare bitwise.
        return _serve_lanes([lambda x=x: run_sampler(pm, x, pos["context"], sampler="euler",
                                                      steps=steps, **kw) for x in noises],
                            ordered=True)

    lanes(2)  # the batch shapes' first library calls, outside every window
    main_tid = threading.get_native_id()

    def syncs(events):
        calls = [e for e in events if e.get("name") in SYNC_CALLS]
        return {"main_thread": sum(e.get("tid") == main_tid for e in calls),
                "all_threads": len(calls)}

    tracing.enable()
    torch.cuda.synchronize()
    with tracing.hardware_trace(os.path.join(directory, "hw_on")):
        on_out, on_dispatches = lanes()
        torch.cuda.synchronize()
    on_events = _chrome_events(tracing.tracer.hardware_traces[-1])
    on_spans = sorted((e for e in tracing.export()["traceEvents"]
                       if e.get("name") == "serving-dispatch"), key=lambda e: e["ts"])
    tracing.disable()
    windows = _annotations(on_events, "serving-dispatch")
    inside = _launched_in(on_events, windows)
    per_dispatch, mismatched = [], []
    for i, (w, acts) in enumerate(zip(windows, inside)):
        kern = [(a["ts"], a["ts"] + a["dur"]) for a in acts if a.get("cat") == "kernel"]
        union = _union_ms(kern)
        busy_us = sum(b - a for a, b in union)
        end = w["ts"] + w["dur"]
        span_us = on_spans[i]["dur"] if i < len(on_spans) else None
        d = {"window_ms": w["dur"] / 1e3, "span_ms": None if span_us is None else span_us / 1e3,
             "kernels": len(kern), "busy_ms": busy_us / 1e3,
             "busy_share": busy_us / w["dur"] if w["dur"] else None,
             "kernels_inside": all(b <= end + 50.0 for _, b in kern),
             # The last kernel's end less the window's end (µs): device timestamps
             # mapped onto the host clock by the profiler, the window on the host's.
             "kernel_end_past_window_us": max((b - end for _, b in kern), default=None)}
        if (span_us is None or not kern or not d["kernels_inside"]
                or not _agree(span_us, w["dur"], SPAN_VS_PROFILER_REL, SPAN_VS_PROFILER_MS)):
            mismatched.append(i)
        per_dispatch.append(d)
    torch.cuda.synchronize()
    with metrics.trace(os.path.join(directory, "hw_off")) as off_window:
        off_out, off_dispatches = lanes()
        torch.cuda.synchronize()
    off_events = _chrome_events(off_window.path)
    sync_on, sync_off = syncs(on_events), syncs(off_events)

    # The overhead: dispatch seconds in turns, off, on, on, off, without a profiler.
    seconds: dict = {"off": [], "on": []}
    timed = StepBucket.dispatch

    def timing_dispatch(bucket, mode=None):
        t0 = time.perf_counter()
        ran = timed(bucket)
        if ran:
            seconds[current[0]].append(time.perf_counter() - t0)
        return ran

    current = ["off"]
    StepBucket.dispatch = timing_dispatch
    try:
        for mode in ("off", "on", "on", "off"):
            current[0] = mode
            if mode == "on":
                tracing.enable()
            lanes()
            tracing.disable()
    finally:
        StepBucket.dispatch = timed
        tracing.tracer.clear()
    busy = [d["busy_share"] for d in per_dispatch if d["busy_share"] is not None]
    # CPU activity tracing slows the host's launches, so a profiled window is longer
    # than the same dispatch unprofiled: its kernels' union (device time, which the
    # profiler does not stretch) over the unprofiled median is the second reading.
    busy_ms = [d["busy_ms"] for d in per_dispatch]
    window_ms = [d["window_ms"] for d in per_dispatch]
    unprofiled_ms = {k: statistics.median(v) * 1e3 for k, v in seconds.items()}
    unprofiled = {
        "profiled_window_ms": window_ms,
        "profiled_window_ms_median": statistics.median(window_ms) if window_ms else None,
        "unprofiled_dispatch_ms_median": unprofiled_ms,
        "profiler_stretch": (statistics.median(window_ms) / unprofiled_ms["on"]
                             if window_ms else None),
        "busy_ms_median": statistics.median(busy_ms) if busy_ms else None,
        "busy_share_of_unprofiled_median": {
            k: statistics.median(busy_ms) / v if busy_ms else None
            for k, v in unprofiled_ms.items()},
    }
    print(f"serving_traced_profile: profiled windows {[round(w, 3) for w in window_ms]} ms, "
          f"unprofiled dispatch medians {unprofiled_ms} ms, kernels' union median "
          f"{unprofiled['busy_ms_median']} ms", flush=True)
    prof = {"phase": "serving_traced_profile", "dispatches_on": on_dispatches,
            "dispatches_off": off_dispatches, "profiled_windows": len(windows),
            "serving_dispatch_spans": len(on_spans), "mismatched": mismatched,
            "per_dispatch": per_dispatch,
            "busy_share_median": statistics.median(busy) if busy else None,
            "busy_share_min": min(busy) if busy else None,
            "busy_share_max": max(busy) if busy else None, **unprofiled,
            "syncs_on": sync_on, "syncs_off": sync_off,
            "syncs_per_dispatch_on": {k: v / max(1, on_dispatches) for k, v in sync_on.items()},
            "syncs_per_dispatch_off": {k: v / max(1, off_dispatches) for k, v in sync_off.items()},
            "dispatch_s_median_off": statistics.median(seconds["off"]),
            "dispatch_s_median_on": statistics.median(seconds["on"]),
            "dispatches_timed": {k: len(v) for k, v in seconds.items()},
            "lanes_bitwise_on_vs_off": all(torch.equal(a, b) for a, b in zip(on_out, off_out)),
            "trace_file_bytes": os.path.getsize(tracing.tracer.hardware_traces[-1]),
            "seconds": time.perf_counter() - start}
    emit(prof)
    if (on_dispatches < 10 or len(windows) != on_dispatches or len(on_spans) != on_dispatches
            or mismatched or sync_on != sync_off or on_dispatches != off_dispatches
            or not prof["lanes_bitwise_on_vs_off"]):
        raise RuntimeError(f"serving_traced_profile check failed: {prof}")
    return {"traced": row, "profile": prof, "launches": launches}


# -- the numerics sentinel, fault plans and the serving lane overlays ---------------------

NUMERICS_STEPS = 12  # the sentinel's width-4 euler lanes: one dispatch a step
NUMERICS_LATENT = (1, 64, 64, 4)  # SD1.5 at 512², one image a lane
NUMERICS_LANE = 2  # the lane a lane-nan plan poisons
SENTINEL_OPS_ITERS = 200
OVERLAY_STEPS = {"plain": 8, "controlnet": 6, "lora": 7, "multi_cond": 5}
OVERLAY_LORA_RANK = 16
OVERLAY_REL_TOL = {"float32": 1e-3, "bfloat16": SD_REL_TOL}  # a lane against its inline run
# K1 at the overlay bucket's shapes: 4 lanes × 3 role blocks (cond, uncond, one extra
# cond) = 12 rows a forward of the base UNet and of the ControlNet's trunk.
OVERLAY_K1_SHAPES = {
    "sd15_w4x3_self_4096_d40": ((12, 4096, 8, 40), (12, 4096, 8, 40), 20, 2),
    "sd15_w4x3_self_1024_d80": ((12, 1024, 8, 80), (12, 1024, 8, 80), 50, 5),
    "sd15_w4x3_self_256_d160": ((12, 256, 8, 160), (12, 256, 8, 160), 50, 5),
    "sd15_w4x3_cross_4096x77_d40": ((12, 4096, 8, 40), (12, 77, 8, 40), 50, 5),
    "sd15_w4x3_cross_1024x77_d80": ((12, 1024, 8, 80), (12, 77, 8, 80), 50, 5),
    "sd15_w4x3_cross_256x77_d160": ((12, 256, 8, 160), (12, 77, 8, 160), 50, 5),
    "sd15_f32_w4x3_self_4096_d40": ((12, 4096, 8, 40), (12, 4096, 8, 40), 10, 1, "float32"),
    "sd15_f32_w4x3_self_1024_d80": ((12, 1024, 8, 80), (12, 1024, 8, 80), 20, 2, "float32"),
    "sd15_f32_w4x3_self_256_d160": ((12, 256, 8, 160), (12, 256, 8, 160), 50, 5, "float32"),
    "sd15_f32_w4x3_cross_4096x77_d40": ((12, 4096, 8, 40), (12, 77, 8, 40), 50, 5, "float32"),
    "sd15_f32_w4x3_cross_1024x77_d80": ((12, 1024, 8, 80), (12, 77, 8, 80), 50, 5, "float32"),
    "sd15_f32_w4x3_cross_256x77_d160": ((12, 256, 8, 160), (12, 77, 8, 160), 50, 5, "float32"),
}
SD15_CONTROLNET_F32_PER_FORWARD = {"tf32x3": 42}  # the base's 30 and the trunk's 12


class fault_plan:
    """An armed ``PA_FAULT_PLAN`` of ``faults`` for a block, under a ``PA_LEDGER_DIR``
    redirect into ``directory`` (a plan fires only under one); the environment and
    the registry restored after."""

    def __init__(self, directory, *faults):
        import os

        self.env = {"PA_FAULT_PLAN": json.dumps(list(faults)),
                    "PA_LEDGER_DIR": os.path.join(directory, "fault_ledger")}

    def __enter__(self):
        import os

        from comfyui_parallelanything_tpu_torch.utils import faults

        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        faults.reload()
        return faults

    def __exit__(self, *exc):
        import os

        from comfyui_parallelanything_tpu_torch.utils import faults

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reload()


def sync_calls(path: str) -> int:
    """The synchronise calls (``SYNC_CALLS``, every thread) in a profiler trace."""
    return sum(1 for e in _chrome_events(path) if e.get("name") in SYNC_CALLS)


def window_summary(path: str) -> dict:
    """A profiler window's device kernels and copies (count, summed ms) and its CUDA
    runtime calls by name (count, summed host ms)."""
    out: dict = {"kernels": [0, 0.0], "copies": [0, 0.0], "runtime": {}}
    for e in _chrome_events(path):
        cat, dur = e.get("cat"), e.get("dur", 0) / 1e3
        slot = ({"kernel": out["kernels"], "gpu_memcpy": out["copies"]}.get(cat)
                or (out["runtime"].setdefault(e.get("name"), [0, 0.0])
                    if cat == "cuda_runtime" else None))
        if slot is not None:
            slot[0] += 1
            slot[1] += dur
    return out


def _counter(name: str, **labels) -> float:
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    return registry.get(name, labels or None) or 0.0


def _counter_total(name: str) -> float:
    """A counter summed over its label sets."""
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    return sum(float(line.rsplit(" ", 1)[1]) for line in registry.render().splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


def _sum(*ds: dict) -> dict:
    return {k: sum(d.get(k, 0) for d in ds) for k in set().union(*ds)}


def _scaled(per: dict, n: int) -> dict:
    return {v: c * n for v, c in per.items() if c * n}


def sentinel_captured(phase: str, run, per_replay: dict, per_forward: dict,
                      directory) -> dict:
    """The numerics sentinel on a captured loop (after the phase's ``captured_turns``):
    with it on, a capturing call (its warm-up runs one real forward, ``per_forward``
    K1 launches) and a replay (the flag keys a capture of its own, which must record
    the same ``per_replay`` K1 launches) and the eager loop; the
    captured digests, read after the replays through the sentinel's deferred read,
    must equal the eager loop's and ``digest()`` of the latents, the captured latent
    bitwise the eager one, with no non-finite event. Then a ``compile-fail`` plan: one
    ``compile-eager`` rung, the eager latent bitwise. Returns K1's launches by path."""
    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling import compiled
    from comfyui_parallelanything_tpu_torch.utils import numerics

    start = time.perf_counter()
    compiled.clear_compiled_loops()
    numerics.sentinel.reset()
    numerics.enable()
    try:
        torch.cuda.synchronize()
        fa.reset_launches()
        captured = [run(True), run(True)]
        eager = run(False)
        torch.cuda.synchronize()
        launched = _launched(fa)
        numerics.sentinel.flush()
        ring = numerics.sentinel.recent_fingerprints()
        events = numerics.sentinel.event_count
    finally:
        numerics.disable()
    records = compiled.loop_records()
    compiled.clear_compiled_loops()
    torch.cuda.empty_cache()
    rungs0 = compile_eager_rungs()
    with fault_plan(directory, {"site": "compile-fail", "nth": 1}) as faults:
        fa.reset_launches()
        failed = run(True)
        torch.cuda.synchronize()
        fired = faults.fired()
    failed_launches = _launched(fa)
    rungs = compile_eager_rungs() - rungs0
    compiled.clear_compiled_loops()
    torch.cuda.empty_cache()
    want = int(numerics.digest(eager))
    loops = [r["digests"] for r in ring if r["where"].startswith("loop:")]
    eagers = [r["digests"] for r in ring if r["where"].startswith("eager:")]
    row = {"phase": phase, "loops": records, "loop_digests": loops, "eager_digests": eagers,
           "digest": f"{want:08x}", "fingerprint": numerics.latent_fingerprint(eager),
           "captured_bitwise_eager": all(bool(torch.equal(c, eager)) for c in captured),
           "nonfinite_events": events, "k1_launches_by_variant": launched,
           "compile_fail_fired": fired, "compile_eager_rungs": rungs,
           "compile_fail_bitwise_eager": bool(torch.equal(failed, eager)),
           "compile_fail_k1_launches": failed_launches,
           "seconds": time.perf_counter() - start}
    emit(row)
    ok = (len(records) == 1 and records[0]["captured"] == per_replay
          and records[0]["replays"] == 2 and loops == [[want]] * 2 and eagers == [[want]]
          and row["captured_bitwise_eager"] and events == 0
          and launched == _sum(_scaled(per_replay, 2), per_forward)
          and fired == {"compile-fail": 1}
          and rungs == 1 and row["compile_fail_bitwise_eager"]
          and failed_launches == per_replay)
    if not ok:
        raise RuntimeError(f"{phase} check failed: {row}")
    # The capture's launches count once in Python; its two replays ran them twice.
    return {phase: _sum(_scaled(per_replay, 3), per_forward),
            f"{phase}_compile_fail": dict(per_replay)}


def stream_sentinel(sp, step, want, per_fwd: int, directory) -> dict:
    """The streamed step with the numerics sentinel off and then on, each inside a
    ``torch.profiler`` window: the same synchronise calls (the runner counts each
    stage's non-finite elements on the compute stream and reads them after the
    caller's synchronise), per-stage counts of 0, the latent bitwise the resident
    one. Then a ``stream-prefetch-oom`` plan at stage 1: one ``stream-recarve`` rung,
    a finer carve, the latent still bitwise. Returns K1's launches by path."""
    import os

    import torch

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.utils import metrics, numerics

    start = time.perf_counter()
    runner = sp._stream_runner
    outs, syncs, launches = {}, {}, {}
    numerics.sentinel.reset()
    try:
        for mode in ("off", "on"):
            if mode == "on":
                numerics.enable()
            torch.cuda.synchronize()
            fa.reset_launches()
            with metrics.trace(os.path.join(directory, f"stream_sentinel_{mode}")) as window:
                outs[mode] = step()
                torch.cuda.synchronize()
            launches[mode] = _launched(fa)
            syncs[mode] = sync_calls(window.path)
        numerics.sentinel.flush()
        counts = runner.last_stage_counts
        events = numerics.sentinel.event_count
    finally:
        numerics.disable()
    n0 = runner.n_stages
    rungs0 = _counter("pa_degradation_total", rung="stream-recarve")
    with fault_plan(directory, {"site": "stream-prefetch-oom", "match": "1", "nth": 1}) as faults:
        fa.reset_launches()
        recarved = step()
        torch.cuda.synchronize()
        fired = faults.fired()
    recarve_launches = _launched(fa)
    row = {"phase": "stream_sentinel", "stages": n0, "stage_nonfinite_counts": counts,
           "nonfinite_events": events, "syncs_off": syncs["off"], "syncs_on": syncs["on"],
           "bitwise_on_vs_resident": bool(torch.equal(outs["on"], want)),
           "bitwise_off_vs_resident": bool(torch.equal(outs["off"], want)),
           "k1_launches_by_variant": launches,
           "prefetch_oom_fired": fired,
           "stream_recarve_rungs": _counter("pa_degradation_total", rung="stream-recarve")
           - rungs0,
           "stages_after_recarve": sp._stream_runner.n_stages,
           "recarve_bitwise_vs_resident": bool(torch.equal(recarved, want)),
           "recarve_k1_launches": recarve_launches, "seconds": time.perf_counter() - start}
    emit(row)
    one = _scaled({"sm90": per_fwd}, 1)
    if not (counts == [0] * (n0 + 1) and events == 0 and syncs["on"] == syncs["off"]
            and row["bitwise_on_vs_resident"] and launches == {"off": one, "on": one}
            and fired == {"stream-prefetch-oom": 1} and row["stream_recarve_rungs"] == 1
            and row["stages_after_recarve"] > n0 and row["recarve_bitwise_vs_resident"]
            and recarve_launches == one):
        raise RuntimeError(f"stream_sentinel check failed: {row}")
    return {"stream_sentinel": _scaled(one, 2), "stream_recarve": one}


def phase_serving_numerics(directory) -> dict:
    """The numerics sentinel on the serving lanes: full-width SD1.5 (random weights
    from a seed) at 512², four euler lanes of ``NUMERICS_STEPS`` steps at CFG 7.5 in a
    width-4 bucket (lane i in slot i), so ``NUMERICS_STEPS`` width-4 dispatches a run.
    In bf16: runs with the sentinel off and on in turns (off, on, on, off, twice), each
    dispatch timed; the sentinel's own per-dispatch work alone (``SENTINEL_OPS_ITERS``
    times: host and synchronised milliseconds); one run each way inside a
    ``torch.profiler`` window, whose synchronise calls must be equal (its kernels,
    copies and CUDA runtime calls are reported); the lanes bitwise equal on and off. Then, in
    bf16 and in float32 (TF32 off): with the sentinel on, each lane's last per-eval
    digest must equal ``digest()`` of its latent; then a ``lane-nan`` plan at lane
    ``NUMERICS_LANE`` (under a ``PA_LEDGER_DIR`` redirect): that submitter gets
    ``NonFiniteLatent`` whose bisection names ``lane-input``, the three survivors are
    bitwise their runs without the injection, and ``pa_numerics_quarantined_total``,
    ``pa_numerics_nonfinite_total{where="serving-lane"}`` and
    ``pa_fault_injected_total{site="lane-nan"}`` each rise by exactly one; K1 exactly
    ``SD15_PER_FORWARD`` (float32: ``SD15_F32_PER_FORWARD``) per dispatch. Returns
    K1's launches by path."""
    import os

    import torch

    from comfyui_parallelanything_tpu_torch import models, parallelize
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler
    from comfyui_parallelanything_tpu_torch.serving.bucket import StepBucket
    from comfyui_parallelanything_tpu_torch.utils import metrics, numerics

    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    paths: dict = {}
    for dtype, per_forward in (("bfloat16", SD15_PER_FORWARD),
                               ("float32", SD15_F32_PER_FORWARD)):
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        if dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            gen = torch.Generator(device=dev).manual_seed(17)
            cfg = models.sd15_config(dtype=getattr(torch, dtype))
            pm = parallelize(models.build_unet(cfg, device=dev, generator=gen),
                             [("cuda:0", 100)])
            conds = [torch.randn((1, 77, cfg.context_dim), generator=gen, device=dev)
                     for _ in range(3)]
            noises = [torch.randn(NUMERICS_LATENT, generator=gen, device=dev)
                      for _ in range(4)]

            def lanes(steps=NUMERICS_STEPS, raise_errors=True):
                return _serve_lanes(
                    [lambda x=x, c=conds[i % 2]: run_sampler(
                        pm, x, c, sampler="euler", steps=steps, cfg_scale=7.5,
                        uncond_context=conds[2]) for i, x in enumerate(noises)],
                    ordered=True, raise_errors=raise_errors)

            lanes(2)  # the batch shapes' first library calls
            row: dict = {"phase": "serving_numerics", "dtype": dtype, "steps": NUMERICS_STEPS}
            numerics.disable()
            numerics.sentinel.reset()
            if dtype == "bfloat16":
                seconds: dict = {"off": [], "on": []}
                timed = StepBucket.dispatch
                current = ["off"]

                def timing_dispatch(bucket):
                    t0 = time.perf_counter()
                    ran = timed(bucket)
                    if ran:
                        seconds[current[0]].append(time.perf_counter() - t0)
                    return ran

                StepBucket.dispatch = timing_dispatch
                try:
                    outs = {}
                    for mode in ("off", "on", "on", "off", "off", "on", "on", "off"):
                        current[0] = mode
                        (numerics.enable if mode == "on" else numerics.disable)()
                        outs.setdefault(mode, lanes()[0])
                finally:
                    StepBucket.dispatch = timed
                    numerics.disable()
                syncs, windows = {}, {}
                for mode in ("off", "on"):
                    (numerics.enable if mode == "on" else numerics.disable)()
                    torch.cuda.synchronize()
                    with metrics.trace(os.path.join(directory, f"numerics_{mode}")) as w:
                        lanes()
                        torch.cuda.synchronize()
                    syncs[mode] = sync_calls(w.path)
                    windows[mode] = window_summary(w.path)
                numerics.disable()
                # The sentinel's own work in a dispatch, alone: per-lane stats and
                # digests of a width-4 state and their copies to page-locked memory.
                state = torch.stack(noises)
                bufs = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SENTINEL_OPS_ITERS):
                    bufs = numerics.to_host_async([numerics.lane_stats(state, extra=state),
                                                   numerics.lane_digest(state)], out=bufs)
                host_s = time.perf_counter() - t0
                torch.cuda.synchronize()
                row.update({
                    "sentinel_ops_host_ms": host_s / SENTINEL_OPS_ITERS * 1e3,
                    "sentinel_ops_ms": (time.perf_counter() - t0) / SENTINEL_OPS_ITERS * 1e3,
                    "dispatch_s_median_off": statistics.median(seconds["off"]),
                    "dispatch_s_median_on": statistics.median(seconds["on"]),
                    "dispatch_s_off": seconds["off"], "dispatch_s_on": seconds["on"],
                    "syncs_off": syncs["off"], "syncs_on": syncs["on"],
                    "window_off": windows["off"], "window_on": windows["on"],
                    "lanes_bitwise_on_vs_off": all(
                        bool(torch.equal(a, b)) for a, b in zip(outs["on"], outs["off"]))})
            numerics.sentinel.reset()
            numerics.enable()
            fa.reset_launches()
            clean, dispatches = lanes()
            launches = _launched(fa)
            finals = sorted(r["digests"][-1] for r in numerics.sentinel.recent_fingerprints()
                            if "rid" in r)
            lane_digests = sorted(int(numerics.digest(x)) for x in clean)
            numerics.sentinel.reset()
            before = (_counter("pa_numerics_nonfinite_total", where="serving-lane"),
                      _counter("pa_fault_injected_total", site="lane-nan"),
                      _counter_total("pa_numerics_quarantined_total"))
            with fault_plan(directory, {"site": "lane-nan", "match": str(NUMERICS_LANE)}):
                fa.reset_launches()
                got, injected_dispatches = lanes(raise_errors=False)
                injected_launches = _launched(fa)
            numerics.disable()
            q = numerics.sentinel.last_quarantine or {}
            bucket = q.get("bucket")
            survivors = {i: bool(torch.equal(got[i], clean[i]))
                         for i in range(4) if i != NUMERICS_LANE}
            err = got[NUMERICS_LANE]
            row.update({
                "dispatches": dispatches, "k1_launches_by_variant": launches,
                "k1_launches_expected": _scaled(per_forward, dispatches),
                "lane_final_digests": [f"{d:08x}" for d in finals],
                "digests_equal_digest_alone": finals == lane_digests,
                "quarantined_error": type(err).__name__, "quarantine_message": str(err),
                "quarantine": {k: q.get(k) for k in ("lane", "step", "sigma", "stats",
                                                     "first_nonfinite", "bundle")},
                "survivors_bitwise": survivors,
                "nonfinite_total_delta": _counter(
                    "pa_numerics_nonfinite_total", where="serving-lane") - before[0],
                "fault_injected_total_delta": _counter(
                    "pa_fault_injected_total", site="lane-nan") - before[1],
                "quarantined_total_delta": _counter_total(
                    "pa_numerics_quarantined_total") - before[2],
                "quarantined_bucket": bucket,
                "quarantined_lanes": numerics.sentinel.quarantined_count,
                "injected_dispatches": injected_dispatches,
                "injected_k1_launches": injected_launches,
                "seconds": time.perf_counter() - start})
            emit(row)
            ok = (launches == row["k1_launches_expected"] and row["digests_equal_digest_alone"]
                  and isinstance(err, numerics.NonFiniteLatent)
                  and (q.get("first_nonfinite") or {}).get("block") == "lane-input"
                  and q.get("lane") == NUMERICS_LANE and all(survivors.values())
                  and row["nonfinite_total_delta"] == 1
                  and row["fault_injected_total_delta"] == 1
                  and row["quarantined_total_delta"] == 1 and row["quarantined_lanes"] == 1
                  and injected_dispatches == dispatches
                  and injected_launches == row["k1_launches_expected"])
            if dtype == "bfloat16":
                ok = ok and row["syncs_on"] == row["syncs_off"] and row["lanes_bitwise_on_vs_off"]
            if not ok:
                raise RuntimeError(f"serving_numerics ({dtype}) check failed: {row}")
            paths[f"serving_numerics_{dtype}"] = launches
            paths[f"serving_numerics_{dtype}_injected"] = injected_launches
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
            numerics.disable()
            numerics.sentinel.reset()
        del pm, clean, got
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def sd15_lora_file(path: str, ckpt: dict, rank: int, seed: int) -> int:
    """A rank-``rank`` kohya LoRA (``lora_unet_…``, ``lora_down`` / ``lora_up`` /
    ``alpha``, float32) over every transformer block's attention q, k, v and output
    projections of an SD1.5 checkpoint (``model.diffusion_model.*``, ldm layout), each
    delta about 5 % of its weight's scale. Writes it; returns its pairs."""
    import torch

    from comfyui_parallelanything_tpu_torch.models.loader import save_safetensors

    gen = torch.Generator().manual_seed(seed)
    lora = {}
    for key, w in ckpt.items():
        if not (key.startswith("model.diffusion_model.") and ".transformer_blocks." in key
                and key.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                                  "to_out.0.weight"))):
            continue
        out_dim, in_dim = w.shape
        name = "lora_unet_" + key[len("model.diffusion_model."):-len(".weight")].replace(
            ".", "_")
        rms = float(w.float().pow(2).mean().sqrt())
        lora[f"{name}.lora_down.weight"] = torch.randn((rank, in_dim), generator=gen)
        lora[f"{name}.lora_up.weight"] = torch.randn(
            (out_dim, rank), generator=gen).mul_(0.05 * rms * rank ** -0.5)
        lora[f"{name}.alpha"] = torch.tensor(float(rank))
    save_safetensors(path, lora)
    return len(lora) // 3


def phase_serving_overlays(paths: dict, directory) -> dict:
    """The serving lane overlays at full width: one width-4 SD1.5 bucket at 512²
    (CFG 7.5, euler) mixing four kinds of lane: plain, ControlNet (the full SD1.5
    ControlNet of ``sd15_controlnet``, zero convolutions random, a 512² hint,
    strength 0.8), per-lane LoRA (rank-``OVERLAY_LORA_RANK`` factors of a kohya file
    over every attention projection, on the graph phase's SD1.5 checkpoint: the stock
    ``LoraLoader``'s bf16 bake has no lane delegate, as ``factorize_bake``'s exact
    test says, and ``LoraLoader._lane_delegate`` recovers the factors from the same
    bake made at float32) and
    multi-cond (one extra cond on the left half at strength 0.7); ragged steps
    (``OVERLAY_STEPS``). First K1 at the bucket's shapes (``OVERLAY_K1_SHAPES``).
    In bf16, then float32 (TF32 off; the same weights upcast, the same factors): each
    lane against its inline run (``OVERLAY_REL_TOL``), no ``ineligible`` fallback, one
    bucket, every dispatch at width 4 running the control trunk (K1 exactly
    ``SD15_CONTROLNET_PER_FORWARD``, float32 ``SD15_CONTROLNET_F32_PER_FORWARD``,
    per dispatch), its seconds against a plain width-4 bucket's and each
    capability's inline s/it. Returns K1's launches by path."""
    import dataclasses
    import os

    import torch

    from comfyui_parallelanything_tpu_torch.models.controlnet import (
        apply_control,
        build_controlnet,
    )
    from comfyui_parallelanything_tpu_torch.models import sd15_config
    from comfyui_parallelanything_tpu_torch.models.lora import lora_signature
    from comfyui_parallelanything_tpu_torch.models.loader import (
        load_safetensors,
        load_sd_unet_checkpoint,
    )
    from comfyui_parallelanything_tpu_torch.nodes_compat import (
        CheckpointLoaderSimple,
        LoraLoader,
    )
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler
    from comfyui_parallelanything_tpu_torch.serving.bucket import StepBucket
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    start = time.perf_counter()
    shapes = graph_k1_shapes(fa, OVERLAY_K1_SHAPES)
    emit({"phase": "serving_overlays", "k1_shapes": shapes})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(29)
    t0 = time.perf_counter()
    lora_path = os.path.join(directory, "overlay_lora.safetensors")
    pairs = sd15_lora_file(lora_path, load_safetensors(paths["ckpt"]), OVERLAY_LORA_RANK, 31)
    base, _, _ = CheckpointLoaderSimple().load(paths["ckpt"], device="cuda:0")
    baked, _ = LoraLoader().load_lora(base, None, lora_path, 1.0, 0.0, device="cuda:0")
    if baked.lora_delegate is not None:
        raise RuntimeError("serving_overlays: a bf16 bake recovered a lane delegate "
                           "(factorize_bake's test is exact: its rounding is full rank)")
    del baked
    # The same bake at float32 (the bf16 file's UNet upcast exactly, the loader's own
    # bake_lora) factorizes exactly; the LoRA lanes of both dtypes carry its factors.
    cfg32 = dataclasses.replace(sd15_config(), dtype=torch.float32)
    sd32 = {k: v.float() for k, v in load_safetensors(paths["ckpt"]).items()
            if k.startswith("model.diffusion_model.")}
    base32 = load_sd_unet_checkpoint(sd32, cfg32, device=dev)
    baked32 = load_sd_unet_checkpoint(sd32, cfg32, lora_path, 1.0, device=dev)
    del sd32
    delegate = LoraLoader._lane_delegate(base32, baked32)
    del baked32
    if delegate is None or delegate["base"] is not base32:
        raise RuntimeError("serving_overlays: the float32 bake recovered no lane delegate")
    factors = delegate["factors"]
    ranks = sorted({int(a.shape[0]) for a, _ in factors.values()})
    lora_s = time.perf_counter() - t0
    cn = build_controlnet(base.config, device=dev, generator=gen)
    randomize_zero_convs(cn.module, gen)
    _, h, w, _ = NUMERICS_LATENT
    hint = torch.rand((1, 8 * h, 8 * w, 3), generator=gen, device=dev)
    ctx_dim = base.config.context_dim
    conds = [torch.randn((1, 77, ctx_dim), generator=gen, device=dev) for _ in range(3)]
    noises = [torch.randn(NUMERICS_LATENT, generator=gen, device=dev) for _ in range(4)]
    extra = {"context": torch.randn((1, 77, ctx_dim), generator=gen, device=dev),
             "strength": 0.7, "area": (h, w // 2, 0, 0)}
    launches_by_path: dict = {}
    for dtype, per_dispatch in (("bfloat16", SD15_CONTROLNET_PER_FORWARD),
                                ("float32", SD15_CONTROLNET_F32_PER_FORWARD)):
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        if dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            model = base32
            net = _upcast(cn, build_controlnet)
        else:
            model, net = base, cn
        try:
            composed = apply_control(model, net, hint, strength=0.8)
            if (composed.control_delegate or {}).get("base") is not model \
                    or lora_signature(factors, model.module) is None:
                raise RuntimeError("serving_overlays: a capability would not ride a lane")
            common = dict(sampler="euler", cfg_scale=7.5, uncond_context=conds[2])
            kinds = {
                "plain": (model, dict(common)),
                "controlnet": (composed, dict(common)),
                "lora": (model, dict(common, lora=factors)),
                "multi_cond": (model, dict(common, extra_conds=(extra,))),
            }

            def call(kind, i, steps=None):
                m, kw = kinds[kind]
                return lambda: run_sampler(m, noises[i], conds[i % 2],
                                           steps=steps or OVERLAY_STEPS[kind], **kw)

            # Inline: each capability's run and its s/it (a second, timed run).
            inline, inline_s_per_it = {}, {}
            for i, kind in enumerate(kinds):
                call(kind, i, 2)()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inline[kind] = call(kind, i)()
                torch.cuda.synchronize()
                inline_s_per_it[kind] = (time.perf_counter() - t0) / OVERLAY_STEPS[kind]
            # The plain bucket: four plain lanes of the same steps, its dispatch seconds.
            seconds: dict = {"plain_bucket": [], "mixed_bucket": []}
            widths: list = []
            timed = StepBucket.dispatch
            current = ["plain_bucket"]

            def timing_dispatch(bucket):
                n = len(bucket.active_lanes())
                t0 = time.perf_counter()
                ran = timed(bucket)
                if ran:
                    seconds[current[0]].append(time.perf_counter() - t0)
                    if current[0] == "mixed_bucket":
                        widths.append({"occupied": n, "width": bucket.width,
                                       "seconds": seconds[current[0]][-1],
                                       "overlays": {"multi_cond": bucket._mc_k,
                                                    "controlnet": bucket._ctrl is not None,
                                                    "lora_targets": len(bucket._lora_sig)}})
                return ran

            StepBucket.dispatch = timing_dispatch
            try:
                _serve_lanes([call("plain", i, 2) for i in range(4)], ordered=True)
                _serve_lanes([call("plain", i, OVERLAY_STEPS["plain"]) for i in range(4)],
                             ordered=True)
                current[0] = "mixed_bucket"
                fallbacks = _counter("pa_serving_inline_fallback_total", reason="ineligible",
                                     sampler="euler")
                torch.cuda.synchronize()
                fa.reset_launches()
                served, dispatches = _serve_lanes(
                    [call(kind, i) for i, kind in enumerate(kinds)], ordered=True)
                torch.cuda.synchronize()
                launches = _launched(fa)
                fell_back = _counter("pa_serving_inline_fallback_total", reason="ineligible",
                                     sampler="euler") - fallbacks
            finally:
                StepBucket.dispatch = timed
            lanes = {kind: {"steps": OVERLAY_STEPS[kind], "rel_l2_vs_inline": rel_l2(s, inline[kind]),
                            "finite": bool(torch.isfinite(s).all().item()),
                            "inline_s_per_it": inline_s_per_it[kind]}
                     for kind, s in zip(kinds, served)}
            row = {"phase": "serving_overlays", "dtype": dtype, "lora_pairs": pairs,
                   "lora_factor_ranks": ranks, "lora_targets": len(factors),
                   "lora_bake_and_factorize_s": lora_s, "lanes": lanes,
                   "dispatches": dispatches, "dispatch_widths": widths,
                   "mixed_dispatch_s_median": statistics.median(seconds["mixed_bucket"]),
                   "plain_dispatch_s_median": statistics.median(seconds["plain_bucket"]),
                   "ineligible_fallbacks": fell_back, "k1_launches_by_variant": launches,
                   "k1_launches_expected": _scaled(per_dispatch, dispatches),
                   "tol_vs_inline": OVERLAY_REL_TOL[dtype],
                   "seconds": time.perf_counter() - start}
            emit(row)
            if not (launches == row["k1_launches_expected"] and fell_back == 0
                    and dispatches == max(OVERLAY_STEPS.values())
                    and all(w["width"] == 4 and w["overlays"]["controlnet"]
                            and w["overlays"]["multi_cond"] == 1 and w["overlays"]["lora_targets"]
                            for w in widths)
                    and all(r["finite"] and r["rel_l2_vs_inline"] <= OVERLAY_REL_TOL[dtype]
                            for r in lanes.values())
                    and ranks == [OVERLAY_LORA_RANK]):
                raise RuntimeError(f"serving_overlays ({dtype}) check failed: {row}")
            launches_by_path[f"serving_overlays_{dtype}"] = launches
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del composed, kinds, served, inline
        if dtype == "float32":
            del model, net
        gc.collect()
        torch.cuda.empty_cache()
    del base, base32, cn, factors, delegate
    gc.collect()
    torch.cuda.empty_cache()
    return launches_by_path


def _upcast(model, build):
    """A float32 twin of a bf16 ``DiffusionModel``: ``build(config, device=,
    state_dict=)`` with its config at float32 and its weights upcast."""
    import dataclasses

    import torch

    cfg = dataclasses.replace(model.config, dtype=torch.float32)
    state = {k: v.float() if v.is_floating_point() else v
             for k, v in model.module.state_dict().items()}
    dev = next(model.module.parameters()).device
    return build(cfg, device=dev, state_dict=state)


def phase_serving(paths: dict, directory) -> dict:
    """The port's server (``server.py``, in this process on ``127.0.0.1:0``) on the
    graph phase's SD1.5 files at full width in bf16: ``workflow_sd15_txt2img`` at
    512², batch 1, CFG 7.5, its save node kept (the images come back through
    ``/history`` and ``/view``), one prompt a ``SERVING_PROMPTS`` row (euler,
    dpmpp_2m, euler_ancestral and heun, 20 or 28 steps, distinct seeds, two texts).
    First K1 at the lanes' shapes (``SERVING_K1_SHAPES``); then the 8 prompts through
    a 1-worker server (the inline path: the reference latents and the images/s to
    beat) and through a 4-worker one (the scheduler and the decode tail installed),
    all posted at once: dispatches, the lanes' mean occupancy and
    ``batched_fraction``, images/s against 1 worker, per-prompt latency p50/p95, s
    per dispatch against the inline s/it, peak memory and K1's launches, which must
    be exactly 20 ``sm90`` + 10 ``wide`` per dispatch plus one ``wide`` per decode
    dispatch; every latent finite and within ``SD_REL_TOL`` of its inline run (the
    stochastic lanes with the same generator). Then each prompt alone through the
    4-worker server (alone in a width-4 bucket, slot 0): a lane that sat in slot 0
    of the concurrent run must be bitwise its alone run (a bf16 row's result depends
    on its slot, so the others are reported). Last the same SD1.5 in float32 (TF32
    off) through the scheduler directly, 8 lanes of ``SERVING_F32_STEPS`` steps:
    every lane bitwise its run alone (in slot 0, whatever its slot was) and within
    ``SERVING_REL_TOL`` of its inline run, exactly 30 ``tf32x3`` per dispatch.
    Returns K1's launches of the concurrent bf16 run and of the float32 lanes."""
    import os
    import threading

    import torch

    from comfyui_parallelanything_tpu_torch import models, nodes, parallelize
    from comfyui_parallelanything_tpu_torch.host import WorkflowCache
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.k_samplers import (
        broadcast_cond_batch,
        make_sigmas,
    )
    from comfyui_parallelanything_tpu_torch.sampling.lane_specs import lane_eval_count
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler
    from comfyui_parallelanything_tpu_torch.server import make_server
    from comfyui_parallelanything_tpu_torch.serving.bucket import (
        StepBucket,
        batched_fraction,
        reset_batch_stats,
    )
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    start = time.perf_counter()
    shapes = graph_k1_shapes(fa, SERVING_K1_SHAPES)
    emit({"phase": "serving", "k1_shapes": shapes})
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(directory, "serving_out")
    latents: dict = {}

    class RecordingKSampler(nodes.TPUKSampler):
        """The graph's sampler node, keeping each run's latent by seed."""

        def sample(self, *args, **kwargs):
            out = super().sample(*args, **kwargs)
            latents[kwargs["seed"]] = out[0]["samples"].clone()
            return out

    def graph(seed, sampler, steps, i):
        wf = graph_example("workflow_sd15_txt2img", paths)
        wf["latent"]["inputs"]["batch_size"] = 1
        wf["sampler"]["inputs"].update(seed=seed, sampler_name=sampler, steps=steps)
        if i % 2:
            wf["positive"]["inputs"]["text"] = SERVING_TEXT_B
        wf["save"] = {"class_type": "TPUSaveImage",
                      "inputs": {"images": ["decode", 0], "filename_prefix": f"serve_{seed}",
                                 "output_dir": out_dir}}
        return wf

    graphs = [graph(s, sa, n, i) for i, (s, sa, n) in enumerate(SERVING_PROMPTS)]
    seeds = [s for s, _, _ in SERVING_PROMPTS]
    cache = WorkflowCache()

    def fresh_samplers():
        # Each pass re-runs the samplers: nothing of the last pass's sampler, decode
        # or save may be served from the cache.
        for nid in ("sampler", "decode", "save"):
            cache.evict(nid)

    def server(workers, trace=None):
        srv, q = make_server(port=0, workers=workers, output_dir=out_dir, cache=cache,
                             class_mappings={"TPUKSampler": RecordingKSampler}, trace=trace)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, q, f"http://127.0.0.1:{srv.server_address[1]}"

    def stop(srv, q):
        srv.shutdown()
        srv.server_close()
        q.shutdown()

    def fallbacks():
        return sum(float(line.rsplit(" ", 1)[1]) for line in registry.render().splitlines()
                   if line.startswith("pa_serving_inline_fallback_total"))

    # 1 worker: the inline path. Two warm-up prompts load the files and encode both
    # texts first (not timed).
    srv, q, base = server(1)
    try:
        _serve_prompts(base, [graph(1, "euler", 2, 0), graph(2, "euler", 2, 1)],
                       together=False)
        fresh_samplers()
        torch.cuda.synchronize()
        inline_run = _serve_prompts(base, graphs, together=True)
    finally:
        stop(srv, q)
    inline = {s: latents.pop(s) for s in seeds}
    # The inline s/it at the graph's shapes (batch 1, CFG in one batch-2 forward).
    res = cache.results
    pm, pos, neg = res["parallel"][0], res["positive"][0], res["negative"][0]
    latent_shape = tuple(res["latent"][0]["samples"].shape)
    side = latent_shape[1] * 2 ** (len(res["checkpoint"][1].cfg.channel_mult) - 1)
    x = nodes.initial_noise(0, latent_shape, dev)
    kw = dict(cfg_scale=7.5, uncond_context=broadcast_cond_batch(neg["context"], 1),
              uncond_kwargs={"y": broadcast_cond_batch(neg["pooled"], 1)},
              y=broadcast_cond_batch(pos["pooled"], 1))
    run_sampler(pm, x, pos["context"], sampler="euler", steps=2, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sampler(pm, x, pos["context"], sampler="euler", steps=10, **kw)
    torch.cuda.synchronize()
    inline_s_per_it = (time.perf_counter() - t0) / 10
    # Why bf16 lanes are held at SD_REL_TOL: a row's result depends on its row.
    rows_bf16 = _row_probe(pm, latent_shape, pos["context"].shape[-1])
    b4 = run_sampler(pm, x.repeat(4, 1, 1, 1), pos["context"].repeat(4, 1, 1),
                     sampler="euler", steps=10, cfg_scale=7.5,
                     uncond_context=neg["context"].repeat(4, 1, 1))
    rows_bf16["inline_batch4_row0_vs_row3_rel_l2"] = rel_l2(b4[3], b4[0])
    del pm, pos, neg, res, b4

    # 4 workers: the scheduler and the decode tail. Each lane's slot is recorded.
    slots: dict = {}
    set_lane = StepBucket._set_lane

    def recording_set_lane(bucket, i, req):
        slots[req.prompt_id] = i
        return set_lane(bucket, i, req)

    srv, q, base = server(SERVING_WORKERS)
    StepBucket._set_lane = recording_set_lane
    try:
        sched, dq = q.scheduler, q.decode_queue

        def step_seconds():
            got = [registry.get("pa_serving_step_seconds", {"bucket": b.label})
                   for b in list(sched.buckets.values())]
            got = [g for g in got if g is not None]
            return sum(g[0] for g in got), sum(g[1] for g in got)

        fresh_samplers()
        fallbacks_before = fallbacks()
        reset_batch_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        d0, dec0, (ss0, sc0) = sched.total_dispatches(), dq.dispatches, step_seconds()
        fa.reset_launches()
        served_run = _serve_prompts(base, graphs, together=True)
        torch.cuda.synchronize()
        launches = _launched(fa)
        dispatches = sched.total_dispatches() - d0
        decodes = dq.dispatches - dec0
        ss1, sc1 = step_seconds()
        peak = torch.cuda.max_memory_allocated(dev)
        occupancy = batched_fraction()
        fell_back = fallbacks() - fallbacks_before
        served = {s: latents.pop(s) for s in seeds}
        served_slots = {s: slots.get(pid) for s, pid in zip(seeds, served_run["pids"])}
        buckets = len(sched.buckets)
        # Each prompt alone: alone in a width-4 bucket, in slot 0.
        fresh_samplers()
        d1 = sched.total_dispatches()
        _serve_prompts(base, graphs, together=False)
        ss2, sc2 = step_seconds()
        alone_dispatches = sched.total_dispatches() - d1
        alone = {s: latents.pop(s) for s in seeds}
    finally:
        StepBucket._set_lane = set_lane
        stop(srv, q)
    n = len(SERVING_PROMPTS)
    lane_evals = sum(lane_eval_count(sa, make_sigmas("karras", st).numpy())
                     for _, sa, st in SERVING_PROMPTS)
    want = {v: c * dispatches for v, c in SD15_PER_FORWARD.items()}
    want["wide"] = want.get("wide", 0) + decodes  # the decode's mid-block attention
    rows = {str(s): {"sampler": sa, "steps": st, "slot": served_slots[s],
                     "bitwise_alone": bool(torch.equal(served[s], alone[s])),
                     "rel_l2_vs_alone": rel_l2(served[s], alone[s]),
                     "rel_l2_vs_inline": rel_l2(served[s], inline[s]),
                     "finite": bool(torch.isfinite(served[s]).all().item())}
            for s, sa, st in SERVING_PROMPTS}
    row = {
        "phase": "serving", "dtype": "bfloat16", "prompts": n, "workers": SERVING_WORKERS,
        "buckets": buckets, "dispatches": dispatches, "decode_dispatches": decodes,
        "lane_evals": lane_evals, "mean_occupancy": lane_evals / max(1, dispatches),
        "batched_fraction": occupancy,
        "images_per_s": n / served_run["wall_s"],
        "images_per_s_1_worker": n / inline_run["wall_s"],
        "speedup": inline_run["wall_s"] / served_run["wall_s"],
        "latency_p50_s": _quantile(served_run["latency_s"], 50),
        "latency_p95_s": _quantile(served_run["latency_s"], 95),
        "latency_p50_s_1_worker": _quantile(inline_run["latency_s"], 50),
        "latency_p95_s_1_worker": _quantile(inline_run["latency_s"], 95),
        "s_per_dispatch": (ss1 - ss0) / max(1, sc1 - sc0),
        "s_per_dispatch_alone": (ss2 - ss1) / max(1, sc2 - sc1),
        "alone_dispatches": alone_dispatches, "inline_s_per_it": inline_s_per_it,
        "peak_gb": peak / 1e9, "k1_launches_by_variant": launches, "k1_launches_expected": want,
        "inline_fallbacks": fell_back, "image_sizes": sorted(set(served_run["image_sizes"])),
        "tol_vs_inline": SD_REL_TOL, "row_probe": rows_bf16, "lanes": rows,
    }
    emit(row)
    slot0 = [s for s, r in rows.items() if r["slot"] == 0]
    bad = [s for s, r in rows.items()
           if not (r["finite"] and r["rel_l2_vs_inline"] <= SD_REL_TOL)
           or (r["slot"] == 0 and not r["bitwise_alone"])]
    if (launches != want or bad or not slot0 or fell_back or dispatches == 0
            or row["image_sizes"] != [(side, side)] or occupancy <= 0.0):
        raise RuntimeError(f"serving: lanes {bad} failed (slot-0 lanes {slot0}), or K1 "
                           f"launched {launches} (want {want}), or {fell_back} runs fell "
                           "back inline")
    gc.collect()
    torch.cuda.empty_cache()

    # Traced: the same prompts through a traced server, then profiled dispatches, and
    # the bf16 row effect bisected layer by layer.
    traced = _serving_traced(server, stop, graphs, seeds, cache, fresh_samplers, directory)
    latents.clear()
    res = cache.results
    bisect = _row_bisect(res["parallel"][0], tuple(res["latent"][0]["samples"].shape),
                         res["positive"][0]["context"].shape[-1])
    del res
    emit({"phase": "serving_row_bisect", **bisect})
    gc.collect()
    torch.cuda.empty_cache()

    # float32, TF32 off: the lanes' update math held at SERVING_REL_TOL.
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator(device=dev).manual_seed(15)
        cfg32 = models.sd15_config(dtype=torch.float32)
        f32 = parallelize(models.build_unet(cfg32, device=dev, generator=gen),
                          [("cuda:0", 100)])
        conds = [torch.randn((1, 77, cfg32.context_dim), generator=gen, device=dev)
                 for _ in range(3)]
        reqs = [(torch.randn(latent_shape, generator=gen, device=dev), conds[i % 2], sa,
                 SERVING_F32_STEPS[i % 2], s)
                for i, (s, sa, _) in enumerate(SERVING_PROMPTS)]

        def call(r):
            noise, ctx, sampler, steps, seed = r
            return lambda: run_sampler(
                f32, noise, ctx, sampler=sampler, steps=steps, cfg_scale=7.5,
                uncond_context=conds[2], rng=torch.Generator(device=dev).manual_seed(seed))

        rows_f32 = _row_probe(f32, latent_shape, cfg32.context_dim)
        fa.reset_launches()
        together, f32_dispatches = _serve_lanes([call(r) for r in reqs])
        f32_launches = _launched(fa)
        alone32 = [_serve_lanes([call(r)])[0][0] for r in reqs]
        inline32 = [call(r)() for r in reqs]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    want32 = {v: c * f32_dispatches for v, c in SD15_F32_PER_FORWARD.items()}
    lanes32 = [{"sampler": r[2], "steps": r[3], "bitwise_alone": bool(torch.equal(t, a)),
                "rel_l2_vs_inline": rel_l2(t, i)}
               for r, t, a, i in zip(reqs, together, alone32, inline32)]
    row32 = {"phase": "serving", "dtype": "float32", "lanes": lanes32,
             "dispatches": f32_dispatches, "k1_launches_by_variant": f32_launches,
             "k1_launches_expected": want32, "tol_vs_inline": SERVING_REL_TOL,
             "row_probe": rows_f32, "seconds": time.perf_counter() - start}
    emit(row32)
    if f32_launches != want32 or not all(
            r["bitwise_alone"] and r["rel_l2_vs_inline"] <= SERVING_REL_TOL for r in lanes32):
        raise RuntimeError(f"serving float32: {row32}")
    del f32, together, alone32, inline32
    gc.collect()
    torch.cuda.empty_cache()
    return {"serving": launches, "serving_f32": f32_launches,
            "serving_traced": traced["launches"]}


def phase_serving_flux(pm, main_s_per_it: float | None = None) -> dict:
    """FLUX-dev through the scheduler directly, before the main path's model is freed:
    four flow lanes (``sampler="euler"``, ``prediction="flow"``, guidance 3.5) of
    ``SERVING_FLUX_STEPS`` steps at 1024² submitted from four threads to a width-4
    scheduler pumped by hand (``_serve_lanes``), so every dispatch is one (4, 4608,
    24, 128) K1 call a block: K1 at that shape first (``SERVING_FLUX_K1_SHAPES``),
    then exactly 57 ``sm90`` a dispatch, s per dispatch against the main path's
    s/it, and each latent within ``SERVING_FLUX_REL_TOL`` of its inline run."""
    import torch

    from comfyui_parallelanything_tpu_torch.models.flux import flux_dev_config
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    start = time.perf_counter()
    shapes = graph_k1_shapes(fa, SERVING_FLUX_K1_SHAPES)
    emit({"phase": "serving_flux", "k1_shapes": shapes})
    cfg = flux_dev_config()
    inputs = [_flux_inputs(cfg, 1, 200 + i) for i in range(len(SERVING_FLUX_STEPS))]

    def run(i):
        x, ctx, y = inputs[i]
        return run_sampler(pm, x, ctx, sampler="euler", steps=SERVING_FLUX_STEPS[i],
                           prediction="flow", guidance=3.5, y=y)

    # One width-4 dispatch first (not counted): the batch-4 shapes' first library calls.
    _serve_lanes([lambda i=i: run_sampler(pm, *inputs[i][:2], sampler="euler", steps=1,
                                          prediction="flow", guidance=3.5, y=inputs[i][2])
                  for i in range(len(inputs))])
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    lanes, dispatches = _serve_lanes([lambda i=i: run(i) for i in range(len(inputs))])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    launches = _launched(fa)
    results = dict(enumerate(lanes))
    t1 = time.perf_counter()
    inline = [run(i) for i in range(len(inputs))]
    torch.cuda.synchronize()
    inline_s_per_it = (time.perf_counter() - t1) / sum(SERVING_FLUX_STEPS)
    rels = [rel_l2(results[i], inline[i]) for i in range(len(inputs))]
    per_forward = cfg.depth + cfg.depth_single_blocks
    want = {"sm90": per_forward * dispatches}
    row = {"phase": "serving_flux", "lanes": len(inputs), "steps": list(SERVING_FLUX_STEPS),
           "dispatches": dispatches, "s_per_dispatch": serve_s / max(1, dispatches),
           "inline_s_per_it": inline_s_per_it, "main_path_s_per_it": main_s_per_it,
           "lane_steps_per_s": sum(SERVING_FLUX_STEPS) / serve_s,
           "inline_steps_per_s": 1.0 / inline_s_per_it,
           "k1_launches_by_variant": launches, "k1_launches_expected": want,
           "rel_l2_vs_inline": rels, "tol": SERVING_FLUX_REL_TOL,
           "finite": all(bool(torch.isfinite(r).all().item()) for r in results.values()),
           "seconds": time.perf_counter() - start}
    emit(row)
    if (launches != want or dispatches != max(SERVING_FLUX_STEPS) or not row["finite"]
            or max(rels) > SERVING_FLUX_REL_TOL):
        raise RuntimeError(f"serving_flux: {row}")
    return {"serving_flux": launches}


WAN_PROMPT = "a red fox running through fresh snow at dawn, cinematic, highly detailed"
WAN_NEGATIVE = "blurry, static, low quality, watermark"
WAN_SIZE = dict(height=480, width=832, frames=81)  # latent 21×60×104: 32760 tokens
WAN_STEPS = 4  # cut from Wan's published 50 to keep the script in its time
WAN_CFG = 5.0
WAN_SHIFT = 5.0
WAN_CAPTURED_STEPS = 2
WAN_REL_TOL = 5e-2  # bf16 Wan DiT forward and video VAE decode, K1 vs plain attention
WAN13_SM90_PER_FORWARD = 60  # 30 blocks × (self + text cross), CFG in one batch-2 call
WAN14_SM90_PER_FORWARD = 120  # 40 blocks × (self + text cross + image cross)
WAN_I2V_STEPS = 2
WAN_I2V_CHECK_FRAMES = 17  # 5 latent frames: 7800 tokens for the plain-attention check


def _wan_run(pipe, dev, spans, **call) -> tuple:
    """One timed ``WanVideoPipeline`` call at ``WAN_SIZE``: K1's launches by variant,
    the spans (encode, VAE encode, decode), s/it from the step stamps and peak memory;
    returns (video, row)."""
    import torch

    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa

    stamps = []

    def on_step(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    spans.clear()
    fa.reset_launches()
    attention._RESOLVED.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    video = pipe(WAN_PROMPT, WAN_NEGATIVE, cfg_scale=WAN_CFG, shift=WAN_SHIFT,
                 rng=torch.Generator(device=dev).manual_seed(15), callback=on_step,
                 **WAN_SIZE, **call)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    first = max(spans["encode_s_end"], spans.get("vae_encode_s_end", 0.0))
    step_s = [b - a for a, b in zip([first] + stamps[:-1], stamps)]
    return video, {
        "total_s": total, "encode_s": spans["encode_s"],
        "vae_encode_s": spans.get("vae_encode_s"), "denoise_s": sum(step_s),
        "decode_s": spans["decode_s"], "s_per_it": sum(step_s) / len(step_s),
        "step_s": step_s, "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "k1_launches_by_variant": _launched(fa),
        "resolved_backends": list(attention.resolved_backends()),
        "video": list(video.shape), "finite": bool(torch.isfinite(video).all().item()),
        "min": video.min().item(), "max": video.max().item(),
    }


def _wan_latent(frames: int = WAN_SIZE["frames"]) -> tuple[int, int, int]:
    """(T, H, W) of the Wan VAE's latent at ``WAN_SIZE`` with ``frames`` frames."""
    return (frames - 1) // 4 + 1, WAN_SIZE["height"] // 8, WAN_SIZE["width"] // 8


def _video_ok(row: dict) -> bool:
    want = [1, WAN_SIZE["frames"], WAN_SIZE["height"], WAN_SIZE["width"], 3]
    return (row["video"] == want and row["finite"] and row["min"] >= 0.0
            and row["max"] <= 1.0 and row["resolved_backends"] == ["pallas"])


def _wan_forward_vs_plain(model, phase, x, t, ctx, want_launches, **kw) -> dict:
    """One Wan DiT forward through K1 (exactly ``want_launches``) against the same
    forward on the plain attention path, within ``WAN_REL_TOL``."""
    import torch

    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa

    fa.reset_launches()
    out_k = model(x, t, ctx, **kw).float()
    torch.cuda.synchronize()
    launches = _launched(fa)
    attention.set_attention_backend("xla")
    try:
        out_p = model(x, t, ctx, **kw).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    out = {"phase": phase, "shape": list(x.shape), "rel_l2_err": rel,
           "max_abs_err": (out_k - out_p).abs().max().item(), "tol": WAN_REL_TOL,
           "finite": bool(torch.isfinite(out_k).all().item()),
           "k1_launches_by_variant": launches}
    emit(out)
    if not (rel <= WAN_REL_TOL and out["finite"] and launches == want_launches):
        raise RuntimeError(f"{phase} check failed: {out}")
    return launches


def _nbytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def phase_wan() -> tuple:
    """``WanVideoPipeline`` with Wan2.1-T2V-1.3B at full width and depth
    (``wan_1_3b_config()``: 1536 wide, 12 heads of 128, 30 blocks, FFN 8960), UMT5-XXL
    at 512 tokens and the Wan VAE, random bf16 weights from a seeded generator, the
    DiT through ``parallelize`` on ``[("cuda:0", 100)]``: 480×832, 81 frames,
    ``WAN_STEPS`` flow_euler steps at shift 5, CFG 5 with a negative prompt. Exactly
    60 ``sm90`` a forward and one ``wide`` for the decode; the video finite,
    (1, 81, 480, 832, 3), in [0, 1]. Then one DiT forward and one decode against
    plain attention, one profiled step, and ``WAN_CAPTURED_STEPS`` steps captured
    against eager in turns (bitwise equal, 60 ``sm90`` a forward per replay).
    Returns K1's launches by path, and the VAE, UMT5 and tokenizer for the i2v
    phase."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.text_encoders import (
        build_t5_encoder,
        umt5_xxl_config,
    )
    from comfyui_parallelanything_tpu_torch.models.video_vae import (
        build_video_vae,
        wan_vae_config,
    )
    from comfyui_parallelanything_tpu_torch.models.wan import build_wan, wan_1_3b_config
    from comfyui_parallelanything_tpu_torch.ops import attention
    from comfyui_parallelanything_tpu_torch.pipelines import WanVideoPipeline
    from comfyui_parallelanything_tpu_torch.sampling import compiled
    from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler

    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(14)
    t0 = time.perf_counter()
    dit = build_wan(wan_1_3b_config(), device=dev, generator=gen)
    t5 = build_t5_encoder(umt5_xxl_config(), device=dev, generator=gen)
    vae = build_video_vae(wan_vae_config(), device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _, t5_tok = synthetic_tokenizers()
    pm = parallelize(dit, [("cuda:0", 100)])
    pipe = WanVideoPipeline(dit=pm, vae=vae, t5=t5, t5_tokenizer=t5_tok)
    spans: dict[str, float] = {}
    pipe.encode_prompt = _timed_span(spans, "encode_s", pipe.encode_prompt)
    vae.decode = _timed_span(spans, "decode_s", vae.decode)
    vae.encode = _timed_span(spans, "vae_encode_s", vae.encode)
    # Warm-up (UMT5, the DiT, the VAE decoder), not counted: 5 frames, one step.
    pipe(WAN_PROMPT, WAN_NEGATIVE, steps=1, **{**WAN_SIZE, "frames": 5})
    torch.cuda.synchronize()
    video, row = _wan_run(pipe, dev, spans, steps=WAN_STEPS)
    want = {"sm90": WAN13_SM90_PER_FORWARD * WAN_STEPS, "wide": 1}
    res = {"phase": "wan", "model": "wan2.1-t2v-1.3b", "build_s": build_s,
           "n_params": {"dit": dit.n_params(),
                        "umt5_xxl": sum(p.numel() for p in t5.module.parameters()),
                        "vae": sum(p.numel() for p in vae.module.parameters())},
           "weight_bytes": {"dit": _nbytes(dit.module), "umt5_xxl": _nbytes(t5.module),
                            "vae": _nbytes(vae.module)},
           "steps": WAN_STEPS, "cfg_scale": WAN_CFG, "shift": WAN_SHIFT, **WAN_SIZE,
           "tokens": math.prod(_wan_latent()) // 4, **row, "k1_launches_expected": want}
    emit(res)
    if row["k1_launches_by_variant"] != want or not _video_ok(row):
        raise RuntimeError(f"wan check failed: {res}")
    del video

    ctx_shape = (2, t5_tok.max_len, t5.cfg.d_model)
    x = torch.randn((2, *_wan_latent(), 16), generator=gen, device=dev)
    ctx = torch.randn(ctx_shape, generator=gen, device=dev)
    t = torch.tensor([0.9, 0.9], device=dev)
    forward = _wan_forward_vs_plain(pm, "wan_vs_plain_attention", x, t, ctx,
                                    {"sm90": WAN13_SM90_PER_FORWARD})
    z = torch.randn((1, *_wan_latent(), 16), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out_k = vae.decode(z).float()
    decode_peak = torch.cuda.max_memory_allocated(dev)
    attention.set_attention_backend("xla")
    try:
        out_p = vae.decode(z).float()
    finally:
        attention.set_attention_backend("auto")
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    dec = {"phase": "wan_vae_decode_vs_plain_attention", "rel_l2_err": rel,
           "max_abs_err": (out_k - out_p).abs().max().item(), "tol": WAN_REL_TOL,
           "max_memory_allocated": decode_peak}
    emit(dec)
    if not rel <= WAN_REL_TOL:
        raise RuntimeError(f"Wan VAE decode through K1 disagrees with plain attention: {dec}")
    del out_k, out_p, x, z
    context = pipe.encode_prompt([WAN_PROMPT])
    uctx = pipe.encode_prompt([WAN_NEGATIVE])
    noise = torch.randn((1, *_wan_latent(), 16), generator=gen, device=dev)
    profile_step("wan_profile", lambda: run_sampler(
        pm, noise, context, sampler="flow_euler", prediction="flow", steps=1,
        shift=WAN_SHIFT, cfg_scale=WAN_CFG, uncond_context=uctx))
    captured = captured_turns("wan_captured", lambda c: run_sampler(
        pm, noise, context, sampler="flow_euler", prediction="flow",
        steps=WAN_CAPTURED_STEPS, shift=WAN_SHIFT, cfg_scale=WAN_CFG, uncond_context=uctx,
        compile_loop=c), WAN_CAPTURED_STEPS,
        {"sm90": WAN13_SM90_PER_FORWARD * WAN_CAPTURED_STEPS})
    if not captured["bitwise_equal"]:
        raise RuntimeError("wan: the captured latent is not bitwise the eager one")
    compiled.clear_compiled_loops()  # the captured loop's memory pool
    pm.cleanup()
    del pm, pipe, dit
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "wan_seconds", "seconds": time.perf_counter() - start})
    return ({"wan": row["k1_launches_by_variant"], "wan_vs_plain": forward,
             "wan_captured": captured["k1_replayed_launches"]}, (vae, t5, t5_tok))


def phase_wan_i2v(vae, t5, t5_tok) -> dict:
    """``WanVideoPipeline`` image→video with Wan2.1-I2V-14B-480P at full width and
    depth (``wan_14b_i2v_clip_config()``: 5120 wide, 40 heads of 128, 40 blocks, 36
    input channels, the CLIP-vision branch over 257 tokens of 1280), the t2v phase's
    UMT5-XXL and Wan VAE, and the port's CLIP ViT-H/14 vision tower on the start
    image, random bf16 weights from a seeded generator: 480×832, 81 frames (the VAE
    encodes the whole conditioning clip), ``WAN_I2V_STEPS`` steps, CFG 5. Exactly
    120 ``sm90`` a forward, one ``wide`` for the encode and one for the decode; the
    video finite, (1, 81, 480, 832, 3), in [0, 1]. Then one forward against plain
    attention at ``WAN_I2V_CHECK_FRAMES`` frames. The 14B model is freed after."""
    import torch

    from comfyui_parallelanything_tpu_torch import parallelize
    from comfyui_parallelanything_tpu_torch.models.vision import (
        build_clip_vision,
        clip_preprocess,
        clip_vit_h_14_config,
    )
    from comfyui_parallelanything_tpu_torch.models.wan import (
        build_wan,
        wan_14b_i2v_clip_config,
    )
    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa
    from comfyui_parallelanything_tpu_torch.pipelines import WanVideoPipeline

    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    t0 = time.perf_counter()
    dit = build_wan(wan_14b_i2v_clip_config(), device=dev, generator=gen)
    vision = build_clip_vision(clip_vit_h_14_config(), device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    image = torch.rand((1, WAN_SIZE["height"], WAN_SIZE["width"], 3), generator=gen,
                       device=dev)
    fa.reset_launches()
    _, _, penultimate = vision(clip_preprocess(image))
    torch.cuda.synchronize()
    vision_launches = _launched(fa)
    cvo = {"penultimate": penultimate}
    pm = parallelize(dit, [("cuda:0", 100)])
    pipe = WanVideoPipeline(dit=pm, vae=vae, t5=t5, t5_tokenizer=t5_tok)
    spans: dict[str, float] = {}
    pipe.encode_prompt = _timed_span(spans, "encode_s", pipe.encode_prompt)
    vae.decode = _timed_span(spans, "decode_s", vae.decode)
    vae.encode = _timed_span(spans, "vae_encode_s", vae.encode)
    # Warm-up (the 14B DiT and its image branch), not counted: 5 frames, one step.
    pipe(WAN_PROMPT, WAN_NEGATIVE, steps=1, image=image, clip_vision_output=cvo,
         **{**WAN_SIZE, "frames": 5})
    torch.cuda.synchronize()
    video, row = _wan_run(pipe, dev, spans, steps=WAN_I2V_STEPS, image=image,
                          clip_vision_output=cvo)
    want = {"sm90": WAN14_SM90_PER_FORWARD * WAN_I2V_STEPS, "wide": 2}
    res = {"phase": "wan_i2v", "model": "wan2.1-i2v-14b-480p", "build_s": build_s,
           "n_params": {"dit": dit.n_params(),
                        "clip_vision_h": sum(p.numel() for p in vision.module.parameters())},
           "weight_bytes": {"dit": _nbytes(dit.module), "clip_vision_h": _nbytes(vision.module)},
           "steps": WAN_I2V_STEPS, "cfg_scale": WAN_CFG, **WAN_SIZE,
           "clip_vision_k1_launches": vision_launches, **row, "k1_launches_expected": want}
    emit(res)
    if row["k1_launches_by_variant"] != want or not _video_ok(row):
        raise RuntimeError(f"wan_i2v check failed: {res}")
    del video
    x = torch.randn((2, *_wan_latent(WAN_I2V_CHECK_FRAMES), 36), generator=gen, device=dev)
    ctx = torch.randn((2, t5_tok.max_len, t5.cfg.d_model), generator=gen, device=dev)
    t = torch.tensor([0.9, 0.9], device=dev)
    forward = _wan_forward_vs_plain(pm, "wan_i2v_vs_plain_attention", x, t, ctx,
                                    {"sm90": WAN14_SM90_PER_FORWARD},
                                    clip_fea=penultimate.expand(2, -1, -1))
    pm.cleanup()
    del pm, pipe, dit, vision
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "wan_i2v_seconds", "seconds": time.perf_counter() - start})
    return {"wan_i2v": row["k1_launches_by_variant"], "wan_i2v_vs_plain": forward,
            "wan_i2v_clip_vision": vision_launches}


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import comfyui_parallelanything_tpu_torch  # noqa: F401  (fails outside a checkout)

    start = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernel()
    pm, main_launches, main_ref = phase_main_path()
    pipe_launches = phase_pipeline(pm)
    main_captured = phase_main_path_captured(pm)
    serving_flux_launches = phase_serving_flux(pm, main_ref["s_per_it"])
    placement_launches = phase_pipeline_placement(pm)
    stream_launches = phase_stream(pm, main_ref)
    del main_ref
    # Free FLUX-dev before the checkpoint and SD-family phases.
    pm.cleanup()
    del pm
    gc.collect()
    torch.cuda.empty_cache()
    checkpoint_launches = phase_checkpoint()
    sd_launches, sd_captured = phase_sd_pipeline()
    gc.collect()
    torch.cuda.empty_cache()
    sampler_launches, sampler_captured, fallback_launches, sd15 = phase_sd_samplers()
    hybrid_launches = phase_hybrid(sd15)
    del sd15
    gc.collect()
    torch.cuda.empty_cache()
    f32_launches = phase_sd15_f32()
    gc.collect()
    torch.cuda.empty_cache()
    controlnet_launches = phase_sd15_controlnet()
    gc.collect()
    torch.cuda.empty_cache()
    sd3_launches = phase_sd3()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as graph_dir:
        graph_launches, graph_paths = phase_graph(graph_dir)
        stock_launches = phase_graph_stock(graph_paths, graph_dir)
        serving_launches = phase_serving(graph_paths, graph_dir)
        gc.collect()
        torch.cuda.empty_cache()
        numerics_launches = phase_serving_numerics(graph_dir)
        overlay_launches = phase_serving_overlays(graph_paths, graph_dir)
    gc.collect()
    torch.cuda.empty_cache()
    wan_launches, (wan_vae, umt5, umt5_tok) = phase_wan()
    wan_i2v_launches = phase_wan_i2v(wan_vae, umt5, umt5_tok)
    del wan_vae, umt5
    # A captured path's launches are those its graphs replayed: K1's launches recorded
    # at capture times the replays.
    paths = {"main_path": main_launches, **main_captured, **pipe_launches,
             "sd_pipeline": sd_launches, "sd_pipeline_captured": sd_captured,
             "sd_samplers": sampler_launches, "sd_samplers_captured": sampler_captured,
             **fallback_launches, "hybrid": hybrid_launches, "sd15_f32": f32_launches,
             **controlnet_launches,
             **sd3_launches, **placement_launches, **stream_launches, **checkpoint_launches,
             **graph_launches, **stock_launches, **serving_launches, **serving_flux_launches,
             **numerics_launches, **overlay_launches, **wan_launches, **wan_i2v_launches}
    emit({"phase": "wall", "seconds": time.perf_counter() - start})
    sources = {"sm90": "flash_attention_sm90.cuh", "wide": "flash_attention_wide.cuh",
               "mma": "flash_attention.cu", "d512": "flash_attention.cu",
               "tf32x3": "flash_attention_tf32x3.cu", "f32": "flash_attention_f32.cu"}
    emit({"kernels": [{
        "name": "flash_attention",
        "variant": variant,
        "route": "cuda",
        "source": f"comfyui_parallelanything_tpu_torch/csrc/{sources[variant]}",
        "replaces": "comfyui_parallelanything_tpu/ops/pallas/flash_attention.py:95",
        "launches": sum(by_variant.get(variant, 0) for by_variant in paths.values()),
        "launches_by_path": {path: by_variant.get(variant, 0)
                             for path, by_variant in paths.items()},
        "shape": row["shape"],
        "dtype": row["dtype"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_backend": row["library_backend"],
    } for variant, row in rows.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
