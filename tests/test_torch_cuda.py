"""GPU tests of the PyTorch port: the CUDA kernels against their plain versions,
small FLUX, UNet, ControlNet and SD3 models through ``parallelize`` on the card
against the same models on the CPU, a small FLUX streamed from pinned host memory
against the same model resident, the whole-loop compiled sampler's captured
graphs against the eager loop (beside a busy serving dispatcher too, and a capture
that breaks and falls back), the numerics sentinel on a captured loop and a serving
lane kept bitwise beside a quarantined one, Ulysses and the ring over a 4-shard
sequence mesh on the card, a small FLUX with FSDP and tensor-parallel weights on a
2-position mesh, a
``cuda:0`` + ``cpu`` chain, the example graphs
(native and stock names) and the CLIP vision tower on the card against the CPU.
Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; the suite's ``conftest.py`` imports JAX, so on such a machine run
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops import attention  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import controlnet, mmdit  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import text_encoders, unet, vae  # noqa: E402
from comfyui_parallelanything_tpu_torch.pipelines import FluxPipeline  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import compiled  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.flow import flow_euler_sample  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

pytestmark = pytest.mark.cuda

SMALL = dict(hidden_size=256, num_heads=2, depth=2, depth_single_blocks=2, mlp_ratio=2.0,
             context_in_dim=64, vec_in_dim=32, axes_dim=(16, 56, 56), in_channels=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _check_kernel(q, k, v, scale=None, variant=None):
    """Launch K1 once and hold it against its plain version within
    ``chip_smoke.KERNEL_LIMITS`` (the limits the card's smoke run applies). With
    ``variant`` given, the wrapper must have chosen that variant."""
    launches = fa.launches
    before = dict(fa.launches_by_variant)
    chosen = fa.kernel_variant(q, k, v, scale)
    got = fa.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert fa.launches == launches + 1
    assert fa.launches_by_variant[chosen] == before[chosen] + 1
    assert variant is None or chosen == variant
    assert got.shape == q.shape and got.dtype == q.dtype
    res = chip_smoke.kernel_error(got, q, k, v, scale)
    assert res["ok"], res
    return got


@pytest.fixture(autouse=True)
def _no_tf32():
    # The f32 reference must be computed in full f32.
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


# The smoke run's cases, plus a 256-wide head, a small f32 case with D=40, a
# 264-wide head, a single query and key at D=512, and the wide variant past 65535
# batch·heads; then the wide variant at the edges of its padded widths (136, 192,
# 384) and in f16 at D=160, and the d512 variant at an unaligned D=264; then
# tf32x3 at the edges of its head dims (4, 64, 252, 256), a single query and key,
# and 77 keys at D=128; then Wan-shaped ragged calls: 32760 space-time tokens
# (255·128 + 120) at D=128, and the video VAE's D=384 over views of a fused q/k/v
# projection (6240 = 48·128 + 96 positions a frame) and against 257 keys.
@pytest.mark.parametrize(
    "qshape,kshape,dtype_name,layout,variant",
    [c[1:] for c in chip_smoke.KERNEL_CASES]
    + [((2, 130, 3, 256), (2, 70, 3, 256), "bfloat16", "contiguous", "wide"),
       ((1, 100, 2, 40), (1, 77, 2, 40), "float32", "contiguous", "tf32x3"),
       ((2, 65, 3, 264), (2, 129, 3, 264), "bfloat16", "contiguous", "wide"),
       ((1, 1, 1, 512), (1, 1, 1, 512), "bfloat16", "contiguous", "wide"),
       ((65537, 2, 1, 512), (65537, 3, 1, 512), "bfloat16", "contiguous", "wide"),
       ((2, 130, 3, 136), (2, 70, 3, 136), "bfloat16", "contiguous", "wide"),
       ((2, 130, 3, 192), (2, 200, 3, 192), "bfloat16", "contiguous", "wide"),
       ((2, 130, 3, 384), (2, 200, 3, 384), "bfloat16", "contiguous", "wide"),
       ((2, 256, 8, 160), (2, 77, 8, 160), "float16", "contiguous", "wide"),
       ((2, 65, 3, 264), (2, 129, 3, 264), "bfloat16", "unaligned", "d512"),
       ((2, 130, 3, 4), (2, 70, 3, 4), "float32", "contiguous", "tf32x3"),
       ((2, 130, 3, 64), (2, 200, 3, 64), "float32", "contiguous", "tf32x3"),
       ((2, 130, 3, 252), (2, 200, 3, 252), "float32", "contiguous", "tf32x3"),
       ((2, 130, 3, 256), (2, 200, 3, 256), "float32", "contiguous", "tf32x3"),
       ((1, 1, 1, 128), (1, 1, 1, 128), "float32", "contiguous", "tf32x3"),
       ((1, 100, 2, 128), (1, 77, 2, 128), "float32", "contiguous", "tf32x3"),
       ((1, 32760, 2, 128), (1, 32760, 2, 128), "bfloat16", "contiguous", "sm90"),
       ((3, 6240, 1, 384), (3, 6240, 1, 384), "bfloat16", "fused_qkv", "wide"),
       ((2, 1000, 2, 384), (2, 257, 2, 384), "bfloat16", "contiguous", "wide")],
)
def test_flash_attention_kernel_matches_plain(cuda_device, qshape, kshape, dtype_name, layout,
                                              variant):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = chip_smoke.make_case(qshape, kshape, dtype_name, layout, g, cuda_device)
    _check_kernel(q, k, v, variant=variant)


@pytest.mark.parametrize("qshape,kshape", [((2, 300, 4, 128), (2, 513, 4, 128)),
                                           ((2, 300, 4, 40), (2, 513, 4, 40))])
def test_mma_variant_forced_on_aligned_inputs_matches_plain(cuda_device, qshape, kshape):
    # Inputs the sm90 variant would take, launched through the mma variant.
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = chip_smoke.make_case(qshape, kshape, "bfloat16", "contiguous", g, cuda_device)
    assert fa.kernel_variant(q, k, v) == "sm90"
    before = fa.launches_by_variant["mma"]
    got = fa._launch(q, k, v, qshape[-1] ** -0.5, "mma")
    torch.cuda.synchronize()
    assert fa.launches_by_variant["mma"] == before + 1
    res = chip_smoke.kernel_error(got, q, k, v)
    assert res["ok"], res


@pytest.mark.parametrize("variant,qshape,kshape", [
    ("mma", (2, 256, 8, 160), (2, 77, 8, 160)),
    ("mma", (2, 300, 4, 256), (2, 513, 4, 256)),
    ("d512", (2, 300, 2, 512), (2, 513, 2, 512)),
    ("d512", (2, 300, 2, 320), (2, 513, 2, 320)),
])
def test_mma_variants_forced_on_wide_inputs_match_plain(cuda_device, variant, qshape, kshape):
    # Inputs the wide variant takes, launched through the mma.sync variants that
    # serve what TMA cannot take: they stay right on inputs they no longer serve.
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = chip_smoke.make_case(qshape, kshape, "bfloat16", "contiguous", g, cuda_device)
    assert fa.kernel_variant(q, k, v) == "wide"
    before = fa.launches_by_variant[variant]
    got = fa._launch(q, k, v, qshape[-1] ** -0.5, variant)
    torch.cuda.synchronize()
    assert fa.launches_by_variant[variant] == before + 1
    res = chip_smoke.kernel_error(got, q, k, v)
    assert res["ok"], res


@pytest.mark.parametrize("d", [40, 128])
def test_f32_variant_forced_on_tf32x3_inputs_matches_plain(cuda_device, d):
    # Inputs tf32x3 takes, launched through the scalar f32 kernel that keeps the
    # float32 calls tf32x3 cannot take: it stays right on the calls it no longer serves.
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = chip_smoke.make_case((2, 300, 4, d), (2, 513, 4, d), "float32", "contiguous", g,
                                   cuda_device)
    assert fa.kernel_variant(q, k, v) == "tf32x3"
    before = fa.launches_by_variant["f32"]
    got = fa._launch(q, k, v, d ** -0.5, "f32")
    torch.cuda.synchronize()
    assert fa.launches_by_variant["f32"] == before + 1
    res = chip_smoke.kernel_error(got, q, k, v)
    assert res["ok"], res


def test_tf32x3_variant_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros((1, 8, 1, 260), device=cuda_device)
    with pytest.raises(ValueError, match="tf32x3 variant needs"):
        fa._launch(x, x, x, 0.1, "tf32x3")
    y = torch.zeros((1, 8, 1, 128), device=cuda_device)
    with pytest.raises(ValueError, match="positive scale"):
        fa._launch(y, y, y, -0.1, "tf32x3")
    u = torch.zeros(8 * 128 + 1, device=cuda_device)[1:].view(1, 8, 1, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch(u, u, u, 0.1, "tf32x3")
    with pytest.raises(ValueError, match="cannot take"):
        fa._launch(y.bfloat16(), y.bfloat16(), y.bfloat16(), 0.1, "tf32x3")


def test_wide_variant_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros((1, 8, 1, 128), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wide variant needs"):
        fa._launch(x, x, x, 0.1, "wide")
    y = torch.zeros((1, 8, 1, 512), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="positive scale"):
        fa._launch(y, y, y, -0.1, "wide")
    u = torch.zeros(8 * 512 + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 8, 1, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch(u, u, u, 0.1, "wide")


@pytest.mark.parametrize("d,dtype", [(520, torch.bfloat16), (64, torch.float64)])
def test_auto_attention_sends_what_no_variant_takes_to_xla(cuda_device, d, dtype):
    # Under auto, a CUDA call that K1 cannot take (a head dim above 512, float64)
    # takes the xla family, as the JAX package's auto does; a direct flash_attention
    # call still raises.
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((1, 100, 2, d), generator=g, device=cuda_device, dtype=dtype)
               for _ in range(3))
    assert fa.kernel_variant(q, k, v) is None
    attention._RESOLVED.clear()
    launches = fa.launches
    got = attention.attention_local(q, k, v)
    assert attention.resolved_backends() == ("xla",) and fa.launches == launches
    torch.testing.assert_close(got, attention._xla_attention(q, k, v, d ** -0.5))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


def test_sm90_variant_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros((1, 8, 1, 256), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sm90"):
        fa._launch(x, x, x, 0.1, "sm90")
    y = torch.zeros((1, 8, 1, 128), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="positive scale"):
        fa._launch(y, y, y, -0.1, "sm90")


def test_negative_scale_takes_the_mma_variant(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = chip_smoke.make_case((1, 200, 2, 64), (1, 333, 2, 64), "bfloat16", "contiguous",
                                   g, cuda_device)
    before = fa.launches_by_variant["mma"]
    got = fa.flash_attention(q, k, v, scale=-0.125)
    torch.cuda.synchronize()
    assert fa.launches_by_variant["mma"] == before + 1
    res = chip_smoke.kernel_error(got, q, k, v, -0.125)
    assert res["ok"], res


def test_flash_attention_reads_strided_inputs(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((2, 333, 3, 4, 128), generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views, as in the model
    _check_kernel(q, k, v, scale=0.05, variant="sm90")


def test_flash_attention_takes_more_than_65535_batch_heads(cuda_device):
    # gridDim.y holds at most 65535 (batch, head) slices: the launch is split.
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((65600, 3, 1, 8), generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    got = _check_kernel(q, k, v, variant="sm90")
    tail = chip_smoke.kernel_error(got[65535:], q[65535:], k[65535:], v[65535:])
    assert tail["ok"], tail  # the second launch's 65 rows on their own


def test_flash_attention_keeps_the_current_device(cuda_device):
    # On the last card while another is current: the result is right and the
    # caller's current device is unchanged.
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, 100, 2, 64), generator=g, device=dev).bfloat16()
               for _ in range(3))
    with torch.cuda.device(0):
        _check_kernel(q, k, v)
        assert torch.cuda.current_device() == 0


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 1, 520), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims up to 512"):
        fa.flash_attention(x, x, x)
    w = torch.zeros((1, 8, 1, 512), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mma variant takes head dims up to 256"):
        fa._launch(w, w, w, 0.1, "mma")
    with pytest.raises(ValueError, match="cannot take"):
        fa._launch(w.float(), w.float(), w.float(), 0.1, "d512")
    y = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        fa.flash_attention(y, y, y)
    z = torch.zeros((1, 8, 64, 2), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa.flash_attention(z, z, z)


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_small_flux_on_the_card_matches_the_cpu(cuda_device, dtype, rel_tol):
    cfg = flux.flux_dev_config(**SMALL, dtype=dtype)
    cpu_model = flux.build_flux(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = flux.build_flux(cfg, device=cuda_device, state_dict=cpu_model.module.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 32, 32, 4), generator=g)
    ctx = torch.randn((2, 16, 64), generator=g)
    y = torch.randn((2, 32), generator=g)
    want = flow_euler_sample(cpu_model, x, ctx, steps=2, guidance=3.5, y=y)
    pm = parallelize(gpu_model, [("cuda:0", 100)])
    launches = fa.launches
    got = flow_euler_sample(pm, x.to(cuda_device), ctx.to(cuda_device), steps=2, guidance=3.5,
                            y=y.to(cuda_device))
    assert fa.launches - launches == 2 * (cfg.depth + cfg.depth_single_blocks)
    assert "pallas" in attention.resolved_backends()
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= rel_tol, rel


def test_small_flux_data_parallel_over_every_card(cuda_device):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two CUDA devices")
    cfg = flux.flux_dev_config(**SMALL, dtype=torch.float32)
    cpu_model = flux.build_flux(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = flux.build_flux(cfg, device=cuda_device, state_dict=cpu_model.module.state_dict())
    g = torch.Generator().manual_seed(1)
    batch = 2 * n - 1  # padded to 2 per card
    x = torch.randn((batch, 32, 32, 4), generator=g)
    ctx = torch.randn((batch, 16, 64), generator=g)
    y = torch.randn((batch, 32), generator=g)
    want = flow_euler_sample(cpu_model, x, ctx, steps=2, guidance=3.5, y=y)
    pm = parallelize(gpu_model, [(f"cuda:{i}", 100 / n) for i in range(n)])
    assert pm.n_devices == n
    launches = fa.launches
    got = flow_euler_sample(pm, x.to(cuda_device), ctx.to(cuda_device), steps=2, guidance=3.5,
                            y=y.to(cuda_device))
    assert fa.launches - launches == 2 * n * (cfg.depth + cfg.depth_single_blocks)
    assert got.device == cuda_device and torch.cuda.current_device() == 0
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel


STREAM_FLUX = dict(SMALL, hidden_size=1024, num_heads=8, depth_single_blocks=4)
# Device bytes a streamed call may hold beyond its two slots and resident weights:
# the activations of a batch-2, 32×32-latent FLUX call, cuBLAS workspaces, and the
# slots' alignment padding (at most 255 bytes a tensor).
STREAM_ACTIVATION_MARGIN = 32 * 2**20


@pytest.mark.parametrize("overlap", [True, False])
def test_streamed_small_flux_pins_its_host_copy_and_matches_resident(cuda_device, overlap):
    from comfyui_parallelanything_tpu_torch import ParallelConfig
    from comfyui_parallelanything_tpu_torch.models.loader import params_nbytes

    cfg = flux.flux_dev_config(**STREAM_FLUX, dtype=torch.bfloat16)
    host_model = flux.build_flux(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x, ctx, y = (torch.randn(s, generator=g).to(cuda_device)
                 for s in ((2, 32, 32, 4), (2, 16, 64), (2, 32)))
    resident = parallelize(flux.build_flux(cfg, device=cuda_device,
                                           state_dict=host_model.module.state_dict()),
                           [("cuda:0", 100)])
    want = flow_euler_sample(resident, x, ctx, steps=2, guidance=3.5, y=y)
    del resident
    torch.cuda.empty_cache()
    total = params_nbytes(host_model.module)
    pm = parallelize(host_model, [("cuda:0", 100)],
                     ParallelConfig(hbm_budget_bytes=total // 2, stream_overlap=overlap))
    assert pm.is_streaming
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launches = fa.launches_by_variant["sm90"]
    got = flow_euler_sample(pm, x, ctx, steps=2, guidance=3.5, y=y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    runner = pm._stream_runner
    host = runner._master.host.buffer
    assert host.is_pinned() and runner.pinned_nbytes == host.numel() >= runner.streamed_nbytes
    assert runner.n_stages >= 3 and runner.overlap == overlap
    assert fa.launches_by_variant["sm90"] - launches == 2 * (cfg.depth + cfg.depth_single_blocks)
    assert runner.tracker.peak_bytes <= 2 * runner.max_stage_nbytes
    assert runner.tracker.live_bytes == 0
    bound = 2 * runner.max_stage_nbytes + runner.tracker.resident_bytes + STREAM_ACTIVATION_MARGIN
    assert peak <= bound < total, (peak, bound, total)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= 1e-3, rel


PIPE_FLUX = dict(hidden_size=64, num_heads=2, depth=1, depth_single_blocks=1, mlp_ratio=2.0,
                 context_in_dim=32, vec_in_dim=16, axes_dim=(8, 12, 12), in_channels=64)
PIPE_CLIP = dict(vocab_size=600, hidden_size=48, num_layers=2, num_heads=4, max_len=16,
                 projection_dim=16)
PIPE_T5 = dict(vocab_size=600, d_model=32, num_layers=2, num_heads=4, d_kv=8, d_ff=64)


def _small_pipeline(device, dtype, vae_base, vae_groups):
    """A small FluxPipeline on ``device`` in ``dtype``, with weights made on the CPU
    from seeded generators (the same for every device)."""
    tok, t5_tok = chip_smoke.synthetic_tokenizers()
    tok.max_len = PIPE_CLIP["max_len"]
    t5_tok.max_len = 16
    gen = torch.Generator().manual_seed(0)
    cpu = {}
    cpu["dit"] = flux.build_flux(flux.FluxConfig(**PIPE_FLUX, dtype=dtype), device="cpu",
                                 generator=gen)
    vcfg = vae.VAEConfig(z_channels=16, base_channels=vae_base, channel_mult=(1, 2),
                         num_res_blocks=1, norm_groups=vae_groups, use_quant_conv=False,
                         dtype=dtype)
    cpu["vae"] = vae.build_vae(vcfg, device="cpu", generator=gen)
    tcfg = text_encoders.T5Config(**PIPE_T5, dtype=dtype)
    # CLIP's ids (BOS/EOS 49406/49407) need CLIP-L's table size.
    ccfg = text_encoders.CLIPTextConfig(**{**PIPE_CLIP, "vocab_size": 49408},
                                        eos_id=tok.eos_id, dtype=dtype)
    cpu["clip"] = text_encoders.build_clip_text(ccfg, device="cpu", generator=gen)
    cpu["t5"] = text_encoders.build_t5_encoder(tcfg, device="cpu", generator=gen)
    if device.type == "cpu":
        parts = cpu
    else:
        parts = {
            "dit": flux.build_flux(cpu["dit"].config, device=device,
                                   state_dict=cpu["dit"].module.state_dict()),
            "vae": vae.build_vae(vcfg, device=device, state_dict=cpu["vae"].module.state_dict()),
            "clip": text_encoders.build_clip_text(ccfg, device=device,
                                                  state_dict=cpu["clip"].module.state_dict()),
            "t5": text_encoders.build_t5_encoder(tcfg, device=device,
                                                 state_dict=cpu["t5"].module.state_dict()),
        }
    return FluxPipeline(dit=parallelize(parts["dit"], [(str(device), 100)]), vae=parts["vae"],
                        clip=parts["clip"], t5=parts["t5"], tokenizer=tok, t5_tokenizer=t5_tok)


def test_small_pipeline_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    # f32 end to end (TF32 off for matmuls and convolutions): the card's run goes
    # through K1's tf32x3 variant for the DiT (head dim 32) and the VAE (64) and must
    # match the CPU's.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    noise = torch.randn((1, 8, 8, 16), generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr("comfyui_parallelanything_tpu_torch.pipelines.initial_noise",
                        lambda shape, g, d: noise.to(d))
    init = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(2))
    kw = dict(steps=2, height=16, width=16, guidance=3.5)
    images = {}
    for dev in (torch.device("cpu"), cuda_device):
        pipe = _small_pipeline(dev, torch.float32, vae_base=32, vae_groups=8)
        fa.reset_launches()
        images[dev.type] = (pipe("a horse on the moon", **kw).cpu(),
                            pipe("a horse", init_image=init, denoise=0.5, **kw).cpu())
        launched = dict(fa.launches_by_variant)
    # txt2img: 2 steps × 2 blocks + 1 decode; img2img: 1 encode + 2 steps × 2 + 1 decode.
    assert launched == {"sm90": 0, "mma": 0, "f32": 0, "d512": 0, "wide": 0,
                        "tf32x3": 4 + 1 + 1 + 4 + 1}
    for got, want in zip(images["cuda"], images["cpu"]):
        assert got.shape == (1, 16, 16, 3)
        rel = ((got - want).norm() / want.norm()).item()
        assert rel < 1e-4, rel


def test_small_bf16_pipeline_takes_the_d512_variant(cuda_device):
    # A VAE whose mid blocks are 512 channels wide, as in every kl-f8 VAE: its
    # attention is one 512-wide head, which K1 serves with the wide variant (the
    # d512 variant served it before wide existed; it now takes only what TMA cannot).
    pipe = _small_pipeline(cuda_device, torch.bfloat16, vae_base=256, vae_groups=32)
    fa.reset_launches()
    img = pipe("a horse on the moon", steps=2, height=32, width=32)
    torch.cuda.synchronize()
    assert fa.launches_by_variant["wide"] == 1 and fa.launches_by_variant["sm90"] == 4
    assert fa.launches_by_variant["d512"] == 0
    assert img.shape == (1, 32, 32, 3) and img.dtype == torch.bfloat16
    assert torch.isfinite(img).all() and img.min() >= 0 and img.max() <= 1



# A small SD1.5-shaped UNet whose heads are 40, 80 and 160 wide, as SD1.5's are.
SMALL_UNET = dict(model_channels=80, channel_mult=(1, 2, 4), num_res_blocks=1,
                  attention_levels=(0, 1, 2), transformer_depth=(1, 1, 1), num_heads=2,
                  context_dim=64, norm_groups=8)


@pytest.mark.parametrize("dtype,rel_tol,variants",
                         [(torch.float32, 1e-4, {"tf32x3": 20}),
                          (torch.bfloat16, 5e-2, {"sm90": 12, "wide": 8})])
def test_small_unet_sampler_on_the_card_matches_the_cpu(cuda_device, monkeypatch, dtype,
                                                        rel_tol, variants):
    # dpmpp_2m, 2 steps, CFG (cond ‖ uncond in one batch-2 forward per step): 10
    # transformer blocks per forward (3 input, 1 middle, 6 output) make 20 attention
    # calls, 12 at head dims 40 and 80 and 8 at 160. In bf16 the card and the CPU
    # round differently (about 1.5 % relative L2 per forward, as FLUX-dev's forward
    # on the card reads against plain attention), and CFG 5 scales the cond-uncond
    # difference by 5, so the sampled latent is held to 5e-2.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = unet.UNetConfig(**SMALL_UNET, dtype=dtype)
    cpu_model = unet.build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = unet.build_unet(cfg, device=cuda_device,
                                state_dict=cpu_model.module.state_dict())
    g = torch.Generator().manual_seed(1)
    noise = torch.randn((1, 32, 32, 4), generator=g)
    ctx, uctx = torch.randn((1, 77, 64), generator=g), torch.randn((1, 77, 64), generator=g)
    kw = dict(sampler="dpmpp_2m", steps=2, cfg_scale=5.0)
    want = run_sampler(cpu_model, noise, ctx, uncond_context=uctx, **kw)
    pm = parallelize(gpu_model, [("cuda:0", 100)])
    fa.reset_launches()
    got = run_sampler(pm, noise.to(cuda_device), ctx.to(cuda_device),
                      uncond_context=uctx.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert {v: n for v, n in fa.launches_by_variant.items() if n} == {
        v: 2 * n for v, n in variants.items()}
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= rel_tol, rel


# A small SD3.5-medium-shaped MMDiT: 64-wide heads, q/k RMS norm, a dual-attention
# block and the pre-only last block.
SMALL_MMDIT = dict(depth=3, in_channels=16, context_in_dim=64, pooled_dim=32, pos_embed_max=16,
                   qk_norm=True, x_block_self_attn_layers=(0,))


@pytest.mark.parametrize("dtype,rel_tol,variants",
                         [(torch.float32, 1e-4, {"tf32x3": 4}),
                          (torch.bfloat16, 3e-2, {"sm90": 4})])
def test_small_mmdit_sampler_on_the_card_matches_the_cpu(cuda_device, dtype, rel_tol,
                                                         variants):
    # flow_euler, 2 steps, CFG (one batch-2 forward a step): 3 joint attentions over
    # [context ‖ x] (118 = 22 + 96 tokens, ragged) and 1 x-only attention a forward.
    cfg = mmdit.MMDiTConfig(**SMALL_MMDIT, dtype=dtype)
    cpu_model = mmdit.build_mmdit(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = mmdit.build_mmdit(cfg, device=cuda_device,
                                  state_dict=cpu_model.module.state_dict())
    g = torch.Generator().manual_seed(1)
    noise = torch.randn((1, 16, 24, 16), generator=g)
    ctx, uctx = torch.randn((1, 22, 64), generator=g), torch.randn((1, 22, 64), generator=g)
    y, uy = torch.randn((1, 32), generator=g), torch.randn((1, 32), generator=g)
    kw = dict(sampler="flow_euler", prediction="flow", steps=2, shift=3.0, cfg_scale=4.5)
    want = run_sampler(cpu_model, noise, ctx, uncond_context=uctx, uncond_kwargs={"y": uy},
                       y=y, **kw)
    pm = parallelize(gpu_model, [("cuda:0", 100)])
    fa.reset_launches()
    d = cuda_device
    got = run_sampler(pm, noise.to(d), ctx.to(d), uncond_context=uctx.to(d),
                      uncond_kwargs={"y": uy.to(d)}, y=y.to(d), **kw)
    torch.cuda.synchronize()
    assert {v: n for v, n in fa.launches_by_variant.items() if n} == {
        v: 2 * n for v, n in variants.items()}
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= rel_tol, rel


@pytest.mark.parametrize("dtype,rel_tol,variants",
                         [(torch.float32, 1e-4, {"tf32x3": 28}),
                          (torch.bfloat16, 5e-2, {"sm90": 16, "wide": 12})])
def test_small_controlnet_forward_on_the_card_matches_the_cpu(cuda_device, monkeypatch, dtype,
                                                              rel_tol, variants):
    # SMALL_UNET with a ControlNet of the same config (random zero convolutions) and a
    # hint resized from 48² to 256², one batch-2 forward: the base's 20 attention
    # calls (12 at head dims 40 and 80, 8 at 160) and the trunk's 4 transformer blocks
    # (input levels at 40, 80 and 160, the middle at 160), self + cross each.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = unet.UNetConfig(**SMALL_UNET, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    cpu_base = unet.build_unet(cfg, device="cpu", generator=gen)
    cpu_cn = controlnet.build_controlnet(cfg, device="cpu", generator=gen)
    chip_smoke.randomize_zero_convs(cpu_cn.module, gen)
    hint = torch.rand((1, 48, 48, 3), generator=gen)
    kw = dict(strength=0.8, start_percent=0.0, end_percent=0.9)
    want_model = controlnet.apply_control(cpu_base, cpu_cn, hint, **kw)
    gpu_model = controlnet.apply_control(
        unet.build_unet(cfg, device=cuda_device, state_dict=cpu_base.module.state_dict()),
        controlnet.build_controlnet(cfg, device=cuda_device,
                                    state_dict=cpu_cn.module.state_dict()), hint, **kw)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.tensor([700.0, 20.0])
    ctx = torch.randn((2, 77, 64), generator=g)
    want = want_model(x, t, ctx)
    pm = parallelize(gpu_model, [("cuda:0", 100)])
    fa.reset_launches()
    got = pm(x.to(cuda_device), t.to(cuda_device), ctx.to(cuda_device))
    torch.cuda.synchronize()
    assert {v: n for v, n in fa.launches_by_variant.items() if n} == variants
    rel = ((got.cpu().float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= rel_tol, rel


@pytest.fixture
def no_loops():
    yield
    compiled.clear_compiled_loops()


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _captured_against_eager(pm, forwards, variants, noise, ctx, **kw):
    """One sampler run eager, then captured twice: the captured runs equal each
    other and the eager one within 1e-3 relative L2; the capture recorded
    ``variants`` K1 launches per forward; the second call replays the graph
    without a launch from Python."""
    eager = run_sampler(pm, noise, ctx, **kw)
    fa.reset_launches()
    first = run_sampler(pm, noise, ctx, compile_loop=True, **kw)
    (rec,) = [r for r in compiled.loop_records() if r["sampler"] == kw["sampler"]]
    assert rec["captured"] == {v: forwards * n for v, n in variants.items()}
    assert rec["replays"] == 1 and rec["device"] == "cuda:0"
    launched = fa.launches
    again = run_sampler(pm, noise, ctx, compile_loop=True, **kw)
    torch.cuda.synchronize()
    assert fa.launches == launched
    (rec,) = [r for r in compiled.loop_records() if r["sampler"] == kw["sampler"]]
    assert rec["replays"] == 2
    assert torch.equal(first, again)
    assert _rel(first, eager) <= 1e-3, _rel(first, eager)
    return first


@pytest.mark.parametrize("dtype,variants", [(torch.float32, {"tf32x3": 20}),
                                            (torch.bfloat16, {"sm90": 12, "wide": 8})])
def test_small_unet_captured_loop_matches_eager(cuda_device, monkeypatch, no_loops, dtype,
                                                variants):
    # SMALL_UNET's 20 attention calls a forward: one graph captures sm90 and wide
    # (bf16) or tf32x3 (f32). dpmpp_2m and, for the pre-drawn noise table,
    # euler_ancestral, 3 steps at CFG 5 (one forward a step); then the inpaint blend.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = unet.UNetConfig(**SMALL_UNET, dtype=dtype)
    model = unet.build_unet(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    noise = torch.randn((1, 32, 32, 4), generator=g, device=cuda_device)
    ctx, uctx = (torch.randn((1, 77, 64), generator=g, device=cuda_device) for _ in range(2))
    pm = parallelize(model, [("cuda:0", 100)])
    for sampler in ("dpmpp_2m", "euler_ancestral"):
        _captured_against_eager(pm, 3, variants, noise, ctx, sampler=sampler, steps=3,
                                cfg_scale=5.0, uncond_context=uctx,
                                rng=torch.Generator(device=cuda_device).manual_seed(3))
    mask = (torch.rand((1, 32, 32, 1), generator=g, device=cuda_device) > 0.5).float()
    _captured_against_eager(pm, 2, variants, noise, ctx, sampler="euler", steps=2,
                            init_latent=torch.randn_like(noise), latent_mask=mask)


def test_small_flux_captured_loop_matches_eager(cuda_device, no_loops):
    # flow_euler at guidance 3.5, 3 steps: every attention call of the DiT on sm90.
    cfg = flux.flux_dev_config(**SMALL, dtype=torch.bfloat16)
    model = flux.build_flux(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    noise = torch.randn((1, 32, 32, 4), generator=g, device=cuda_device)
    ctx = torch.randn((1, 16, 64), generator=g, device=cuda_device)
    y = torch.randn((1, 32), generator=g, device=cuda_device)
    pm = parallelize(model, [("cuda:0", 100)])
    _captured_against_eager(pm, 3, {"sm90": cfg.depth + cfg.depth_single_blocks}, noise, ctx,
                            sampler="flow_euler", steps=3, guidance=3.5, y=y)


def test_a_broken_capture_falls_back_and_returns_its_memory(cuda_device, no_loops):
    # A model that allocates 256 MiB and then reads a device value on the host while
    # the graph captures: each compile_loop call takes the compile-eager rung and
    # gives the eager latent, the card's reserved bytes come back (the broken graph's
    # private pool ended and released), and a capture after it still works.
    from comfyui_parallelanything_tpu_torch.utils.metrics import registry

    def host_read(x, t, context=None, **kw):
        big = torch.ones(64 * 2**20, device=cuda_device)
        if torch.cuda.is_current_stream_capturing():
            float(x[0, 0, 0, 0])
        return x * 0.9 + 0.0 * big[0]

    g = torch.Generator(device=cuda_device).manual_seed(1)
    noise = torch.randn((1, 8, 8, 4), generator=g, device=cuda_device)
    ctx = torch.randn((1, 4, 8), generator=g, device=cuda_device)
    eager = run_sampler(host_read, noise, ctx, sampler="euler", steps=2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    rungs = registry.get("pa_degradation_total", {"rung": "compile-eager"}) or 0.0
    for _ in range(3):
        got = run_sampler(host_read, noise, ctx, sampler="euler", steps=2, compile_loop=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert torch.equal(got, eager)
        assert torch.cuda.memory_reserved() <= reserved + 2**20
    assert registry.get("pa_degradation_total", {"rung": "compile-eager"}) == rungs + 3
    assert compiled.loop_records() == []
    ok = run_sampler(lambda x, t, context=None, **kw: x * 0.9, noise, ctx, sampler="euler",
                     steps=2, compile_loop=True)
    assert [r["replays"] for r in compiled.loop_records()] == [1]
    assert torch.equal(ok, run_sampler(lambda x, t, context=None, **kw: x * 0.9, noise, ctx,
                                       sampler="euler", steps=2))


def test_capture_beside_a_busy_serving_dispatcher_matches_eager(cuda_device, no_loops):
    # A compile_loop=True prompt is never handed to an installed scheduler; it
    # captures on its own thread while the dispatcher thread runs lanes. The capture
    # holds the dispatcher's lock and captures in thread-local mode
    # (sampling/compiled._capture_guard): it must neither fail nor disturb the lanes.
    import threading
    import time

    from comfyui_parallelanything_tpu_torch.serving import ContinuousBatchingScheduler

    cfg = flux.flux_dev_config(**SMALL, dtype=torch.bfloat16)
    model = flux.build_flux(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    noise = torch.randn((1, 32, 32, 4), generator=g, device=cuda_device)
    ctx = torch.randn((1, 16, 64), generator=g, device=cuda_device)
    y = torch.randn((1, 32), generator=g, device=cuda_device)
    pm = parallelize(model, [("cuda:0", 100)])
    kw = dict(sampler="euler", steps=3, prediction="flow", guidance=3.5, y=y)
    eager = run_sampler(pm, noise, ctx, **kw)
    sched = ContinuousBatchingScheduler(max_width=4).install()
    stop, lanes, errors = threading.Event(), [], []

    def client():
        while not stop.is_set():
            try:
                lanes.append(run_sampler(pm, noise, ctx, **kw))
            except BaseException as e:  # noqa: BLE001 - asserted below
                errors.append(e)
                return

    clients = [threading.Thread(target=client, daemon=True) for _ in range(3)]
    try:
        for t in clients:
            t.start()
        while sched.total_dispatches() < 2:
            time.sleep(0.001)
        dispatched = sched.total_dispatches()
        captured = [run_sampler(pm, noise, ctx, compile_loop=True, **kw) for _ in range(2)]
        assert sched.total_dispatches() > dispatched  # the lanes ran beside the loop
    finally:
        stop.set()
        for t in clients:
            t.join(60)
        sched.shutdown()
    assert not errors, errors
    (rec,) = [r for r in compiled.loop_records() if r["sampler"] == "euler"]
    assert rec["replays"] == 2
    assert torch.equal(captured[0], captured[1])
    assert _rel(captured[0], eager) <= 1e-3
    assert lanes and all(_rel(lane, eager) <= 3e-2 for lane in lanes)


def test_sentinel_on_a_captured_small_unet_loop(cuda_device, monkeypatch, no_loops):
    # The numerics sentinel on a captured SMALL_UNET loop: turning it on changes the
    # loop's cache key (a new capture, whose graph computes the stats and the digest),
    # the replayed latent stays bitwise the sentinel-off one, and the digest read
    # after the replay equals the eager loop's and digest() of the latent.
    from comfyui_parallelanything_tpu_torch.utils import numerics

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = unet.UNetConfig(**SMALL_UNET, dtype=torch.bfloat16)
    model = unet.build_unet(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    noise = torch.randn((1, 32, 32, 4), generator=g, device=cuda_device)
    ctx, uctx = (torch.randn((1, 77, 64), generator=g, device=cuda_device) for _ in range(2))
    pm = parallelize(model, [("cuda:0", 100)])
    kw = dict(sampler="euler", steps=3, cfg_scale=5.0, uncond_context=uctx)
    numerics.disable()
    numerics.sentinel.reset()
    try:
        off = run_sampler(pm, noise, ctx, compile_loop=True, **kw)
        assert len(compiled.loop_records()) == 1
        numerics.enable()
        on = [run_sampler(pm, noise, ctx, compile_loop=True, **kw) for _ in range(2)]
        assert len(compiled.loop_records()) == 2  # the flag keys its own capture
        eager = run_sampler(pm, noise, ctx, **kw)
        torch.cuda.synchronize()
        assert numerics.sentinel.flush() >= 0
        ring = numerics.sentinel.recent_fingerprints()
        assert torch.equal(on[0], off) and torch.equal(on[1], off)
        loops = [r["digests"] for r in ring if r["where"] == "loop:k:euler"]
        assert loops == [[int(numerics.digest(off))]] * 2
        assert [r["digests"] for r in ring if r["where"] == "eager:k:euler"] == \
            [[int(numerics.digest(eager))]]
        assert numerics.sentinel.event_count == 0
    finally:
        numerics.disable()
        numerics.sentinel.reset()


def test_a_survivor_keeps_its_bits_beside_an_injected_lane(cuda_device, monkeypatch,
                                                           tmp_path):
    # Two float32 SMALL_UNET lanes in a width-2 bucket, then the same two with a
    # lane-nan fault plan at lane 1: lane 1's submitter gets NonFiniteLatent naming
    # the lane input, lane 0's latent is bitwise its uninjected one.
    import json
    import threading
    import time

    from comfyui_parallelanything_tpu_torch.serving import ContinuousBatchingScheduler
    from comfyui_parallelanything_tpu_torch.utils import faults, numerics

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = unet.UNetConfig(**SMALL_UNET, dtype=torch.float32)
    model = unet.build_unet(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(2)
    noises = [torch.randn((1, 32, 32, 4), generator=g, device=cuda_device) for _ in range(2)]
    ctx, uctx = (torch.randn((1, 77, 64), generator=g, device=cuda_device) for _ in range(2))

    def two_lanes():
        sched = ContinuousBatchingScheduler(max_width=2, auto=False).install()
        out = {}

        def lane(i):
            try:
                out[i] = run_sampler(model, noises[i], ctx, sampler="euler", steps=3,
                                     cfg_scale=5.0, uncond_context=uctx)
            except Exception as e:  # noqa: BLE001 - asserted below
                out[i] = e

        try:
            threads = []
            for i in range(2):
                threads.append(threading.Thread(target=lane, args=(i,), daemon=True))
                threads[-1].start()
                while sum(len(b.queue) for b in list(sched.buckets.values())) < i + 1:
                    time.sleep(0.002)
            sched.drain()
            for t in threads:
                t.join(60)
        finally:
            sched.shutdown()
        return out

    numerics.disable()
    numerics.sentinel.reset()
    try:
        clean = two_lanes()
        numerics.enable()
        monkeypatch.setenv("PA_FAULT_PLAN", json.dumps([{"site": "lane-nan", "match": "1"}]))
        monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
        got = two_lanes()
        assert isinstance(got[1], numerics.NonFiniteLatent)
        assert numerics.sentinel.last_quarantine["first_nonfinite"]["block"] == "lane-input"
        assert torch.equal(got[0], clean[0])
    finally:
        numerics.disable()
        numerics.sentinel.reset()
        monkeypatch.delenv("PA_FAULT_PLAN")
        faults.reload()


def test_cuda_and_cpu_chain_matches_the_card_alone(cuda_device, monkeypatch, no_loops):
    # SMALL_UNET in f32 on [cuda:0 75, cpu 25], batch 4 at CFG 5 (8 rows a forward):
    # the CPU group computes its rows with plain attention on the host, only the
    # GPU group launches K1, and compile_loop=True runs the eager loop here.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = unet.UNetConfig(**SMALL_UNET, dtype=torch.float32)
    model = unet.build_unet(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    noise = torch.randn((4, 32, 32, 4), generator=g, device=cuda_device)
    ctx, uctx = (torch.randn((4, 77, 64), generator=g, device=cuda_device) for _ in range(2))
    kw = dict(sampler="euler", steps=2, cfg_scale=5.0, uncond_context=uctx)
    want = run_sampler(parallelize(model, [("cuda:0", 100)]), noise, ctx, **kw)
    hybrid = parallelize(model, [("cuda:0", 75), ("cpu", 25)])
    assert [g.platform for g in hybrid._groups] == ["cuda", "cpu"]
    assert hybrid.traceable() is None
    sizes = chip_smoke.hybrid_split(hybrid, 8)
    assert sizes[0] + sizes[1] == 8 and sizes[1] >= 1, sizes
    fa.reset_launches()
    got = run_sampler(hybrid, noise, ctx, compile_loop=True, **kw)
    torch.cuda.synchronize()
    assert compiled.loop_records() == []
    assert fa.launches_by_variant["tf32x3"] == 2 * 20 and fa.launches == 2 * 20
    assert got.device == cuda_device
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_small_flux_pipeline_over_cuda_and_cpu_matches_the_card_alone(cuda_device, no_loops):
    # SMALL in f32 on [cuda:0 50, cpu 50] at batch 1: the blocks placed as a
    # pipeline, the card's stage launching K1 for its blocks only, the host's
    # stage on plain attention; the carry hops to the host and back.
    cfg = flux.flux_dev_config(**SMALL, dtype=torch.float32)
    model = flux.build_flux(cfg, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((1, 32, 32, 4), generator=g, device=cuda_device)
    ctx = torch.randn((1, 16, 64), generator=g, device=cuda_device)
    y = torch.randn((1, 32), generator=g, device=cuda_device)
    want = flow_euler_sample(parallelize(model, [("cuda:0", 100)]), x, ctx, steps=2,
                             guidance=3.5, y=y)
    pp = parallelize(model, [("cuda:0", 50), ("cpu", 50)])
    fa.reset_launches()
    got = flow_euler_sample(pp, x, ctx, steps=2, guidance=3.5, y=y)
    torch.cuda.synchronize()
    runner = pp._pipeline_runner
    assert [st.device.type for st in runner.stages] == ["cuda", "cpu"]
    on_card = runner.stages[0].range[1] - runner.stages[0].range[0]
    assert 0 < on_card < cfg.depth + cfg.depth_single_blocks
    assert fa.launches == fa.launches_by_variant["tf32x3"] == 2 * on_card
    assert got.device == cuda_device
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_small_fp8_flux_checkpoint_converts_on_the_card(cuda_device):
    # A public-layout dict with fp8 block weights, on the card: every converted
    # tensor stays there in its parameter's dtype, equal to the CPU conversion.
    from comfyui_parallelanything_tpu_torch.models.convert import convert_flux_checkpoint
    from comfyui_parallelanything_tpu_torch.models.loader import load_flux_checkpoint

    cfg = flux.flux_dev_config(**SMALL)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    sd = chip_smoke.public_flux_state_dict(cfg, gen, cuda_device)
    lora = chip_smoke.kohya_lora(sd, 4, gen, cuda_device)
    assert sd["single_blocks.0.linear1.weight"].dtype == torch.float8_e4m3fn
    got = convert_flux_checkpoint(sd, cfg, lora)
    want = convert_flux_checkpoint({k: v.cpu() for k, v in sd.items()}, cfg,
                                   {k: v.cpu() for k, v in lora.items()})
    for k, v in want.items():
        assert got[k].device == cuda_device and got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k].cpu().float(), v.float(), rtol=1e-2, atol=1e-3)
    model = load_flux_checkpoint(sd, cfg, lora=lora, device=cuda_device)
    assert all(p.device == cuda_device for p in model.module.parameters())


def test_capture_failure_raises_and_names_the_sampler(cuda_device, no_loops):
    # A host read of a device value inside the loop cannot be captured: the captured
    # entry point raises CaptureError, naming the sampler and the line; run_sampler
    # takes the compile-eager rung for it and gives the eager loop's latent.
    from comfyui_parallelanything_tpu_torch.sampling.k_samplers import make_sigmas

    def reads_the_device(x, t, context=None, **kwargs):
        if float(t[0]) < 0.0:
            return x
        return 0.9 * x

    noise = torch.randn((1, 8, 8, 4), device=cuda_device)
    sigmas = make_sigmas("karras", 2)
    with pytest.raises(compiled.CaptureError, match=r"euler loop .*test_torch_cuda\.py"):
        compiled.compiled_k_sample(
            compiled.trace_spec_of(reads_the_device), "euler", noise * sigmas[0], sigmas,
            None, cfg_scale=1.0, uncond_context=None, uncond_kwargs=None, acp=None,
            prediction="eps", cfg_rescale=0.0)
    assert compiled.loop_records() == []
    got = run_sampler(reads_the_device, noise, None, sampler="euler", steps=2, compile_loop=True)
    assert torch.equal(got, run_sampler(reads_the_device, noise, None, sampler="euler", steps=2))


# The node graph on the card: the shipped txt2img graph on a tiny SD1.5 world
# (f32, written in the public layouts by chip_smoke's writers) through the port's
# host on cuda:0 against the same graph on the CPU, and an int8 model on the card.
GRAPH_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                  transformer_depth=(1, 0), attention_levels=(0,), num_heads=4,
                  norm_groups=8, context_dim=48, dtype=torch.float32)
GRAPH_VAE = dict(z_channels=4, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 norm_groups=8, dtype=torch.float32)
GRAPH_CLIP = dict(hidden_size=48, num_layers=2, num_heads=4, max_len=16,
                  dtype=torch.float32)


def _tiny_graph(tmp_path, monkeypatch, device_id):
    import json

    from comfyui_parallelanything_tpu_torch import models

    cfgs = (unet.UNetConfig(**GRAPH_UNET), vae.VAEConfig(**GRAPH_VAE),
            text_encoders.CLIPTextConfig(**GRAPH_CLIP))
    monkeypatch.setattr(models, "sd15_config", lambda: cfgs[0])
    monkeypatch.setattr(models, "sd_vae_config", lambda: cfgs[1])
    monkeypatch.setattr(text_encoders, "clip_l_config", lambda: cfgs[2])
    gen = torch.Generator().manual_seed(0)
    paths = chip_smoke.write_sd15_files(
        str(tmp_path), unet.build_unet(cfgs[0], device="cpu", generator=gen),
        vae.build_vae(cfgs[1], device="cpu", generator=gen),
        text_encoders.build_clip_text(cfgs[2], device="cpu", generator=gen))
    paths["vocab"], paths["merges"] = chip_smoke.write_clip_tables(str(tmp_path))
    paths["esrgan"] = ""
    wf = chip_smoke.graph_example("workflow_sd15_txt2img", paths)
    wf["clip"]["inputs"]["max_len"] = GRAPH_CLIP["max_len"]
    wf["dev0"]["inputs"]["device_id"] = device_id
    wf["latent"]["inputs"].update(width=32, height=32, batch_size=2)
    wf["sampler"]["inputs"]["steps"] = 2
    return json.loads(json.dumps(wf))


@pytest.fixture
def no_tf32_convs():
    # f32 convolutions in full f32 on the card, as on the host.
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def test_txt2img_graph_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch,
                                                   no_tf32_convs):
    from comfyui_parallelanything_tpu_torch.host import run_workflow

    fa.reset_launches()
    got = run_workflow(_tiny_graph(tmp_path, monkeypatch, "cuda:0"))
    torch.cuda.synchronize()
    assert got["sampler"][0]["samples"].device.type == "cuda"
    # Attention runs through K1: tf32x3 (f32) in the UNet's one transformer level and
    # the VAE's mid-block, two forwards (CFG in one batch) and one decode.
    assert fa.launches_by_variant["tf32x3"] > 0
    want = run_workflow(_tiny_graph(tmp_path, monkeypatch, "cpu"), device="cpu")
    for node in ("positive", "sampler"):
        a = got[node][0]["context" if node == "positive" else "samples"].cpu()
        b = want[node][0]["context" if node == "positive" else "samples"]
        assert chip_smoke.rel_l2(a, b) < 1e-3, node
    assert chip_smoke.rel_l2(got["decode"][0].cpu(), want["decode"][0]) < 1e-3


def test_int8_unet_on_the_card_matches_the_cpu(cuda_device, no_tf32_convs):
    from comfyui_parallelanything_tpu_torch.models.quantize import quantize_model

    cfg = unet.UNetConfig(**GRAPH_UNET)
    gen = torch.Generator().manual_seed(1)
    host = quantize_model(unet.build_unet(cfg, device="cpu", generator=gen), min_size=256)
    card = unet.build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    card = quantize_model(card, min_size=256)
    card.module.to(cuda_device)
    assert {p.dtype for p in card.module.parameters()} == {torch.int8, torch.float32}
    assert all(p.device.type == "cuda" for p in card.module.parameters())
    x = torch.randn(2, 8, 8, 4, generator=gen)
    t = torch.tensor([900.0, 20.0])
    ctx = torch.randn(2, 5, 48, generator=gen)
    got = card(x.to(cuda_device), t.to(cuda_device), ctx.to(cuda_device)).cpu()
    assert chip_smoke.rel_l2(got, host(x, t, ctx)) < 1e-4


def _tiny_stock_graph(tmp_path, monkeypatch, device_id):
    """``workflow_stock_sd15_txt2img`` on the tiny world: the checkpoint with its CLIP
    bundled under ``$PA_MODELS_DIR/checkpoints`` (``chip_smoke.stock_models_dir``),
    32², batch 2, 2 steps, a seed above 2**63."""
    import json

    _tiny_graph(tmp_path, monkeypatch, device_id)  # the world's files and configs
    paths = {"ckpt": str(tmp_path / "sd15.safetensors"),
             "clip": str(tmp_path / "clip_l.safetensors")}
    models_dir = tmp_path / f"stock_{device_id.replace(':', '_')}"
    monkeypatch.setenv("PA_MODELS_DIR", chip_smoke.stock_models_dir(paths, str(models_dir)))
    monkeypatch.setenv("PA_CLIP_VOCAB", str(tmp_path / "vocab.json"))
    monkeypatch.setenv("PA_CLIP_MERGES", str(tmp_path / "merges.txt"))
    with open("examples/workflow_stock_sd15_txt2img.json") as f:
        wf = json.load(f)
    del wf["9"]
    wf["5"]["inputs"].update(width=32, height=32, batch_size=2)
    wf["3"]["inputs"].update(steps=2, seed=2**63 + 7)
    return wf


def test_stock_graph_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch,
                                                 no_tf32_convs):
    from comfyui_parallelanything_tpu_torch.host import run_workflow

    fa.reset_launches()
    got = run_workflow(_tiny_stock_graph(tmp_path, monkeypatch, "cuda:0"))
    torch.cuda.synchronize()
    assert got["3"][0]["samples"].device.type == "cuda"
    assert fa.launches_by_variant["tf32x3"] > 0  # the UNet's and the VAE's attention
    want = run_workflow(_tiny_stock_graph(tmp_path, monkeypatch, "cpu"), device="cpu")
    assert chip_smoke.rel_l2(got["6"][0]["context"].cpu(), want["6"][0]["context"]) < 1e-4
    assert chip_smoke.rel_l2(got["3"][0]["samples"].cpu(), want["3"][0]["samples"]) < 1e-3
    assert chip_smoke.rel_l2(got["8"][0].cpu(), want["8"][0]) < 1e-3


def test_vision_tower_on_the_card_matches_the_cpu(cuda_device):
    from comfyui_parallelanything_tpu_torch.models import vision

    cfg = vision.CLIPVisionConfig(image_size=28, patch_size=7, hidden_size=64, num_layers=2,
                                  num_heads=4, intermediate_size=128, projection_dim=16,
                                  dtype=torch.float32)
    host = vision.build_clip_vision(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    card = vision.build_clip_vision(cfg, device=cuda_device,
                                    state_dict=host.module.state_dict())
    images = torch.rand(2, 40, 36, 3, generator=torch.Generator().manual_seed(3))
    want = host(vision.clip_preprocess(images, size=28))
    got = card(vision.clip_preprocess(images.to(cuda_device), size=28))
    for name, a, b in zip(("embeds", "last", "penultimate"), got, want):
        assert a.device.type == "cuda"
        assert chip_smoke.rel_l2(a.cpu(), b) < 1e-4, name


def test_ulysses_through_k1_and_the_ring_match_plain_attention(cuda_device):
    # Four sequence shards on the one card: Ulysses launches K1 (sm90) once per head
    # slice, a strided view; the ring launches none (its softmax is plain torch).
    from comfyui_parallelanything_tpu_torch.parallel.mesh import build_mesh
    from comfyui_parallelanything_tpu_torch.parallel.sequence import (
        sequence_parallel_attention,
    )

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, 512, 8, 128, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    mesh = build_mesh([cuda_device] * 4, {"seq": 4})
    fa.reset_launches()
    got = sequence_parallel_attention(q, k, v, mesh, method="ulysses")
    torch.cuda.synchronize()
    assert fa.launches_by_variant["sm90"] == fa.launches == 4
    assert chip_smoke.kernel_error(got, q, k, v)["ok"]
    ring = sequence_parallel_attention(q, k, v, mesh, method="ring")
    torch.cuda.synchronize()
    assert fa.launches == 4
    assert chip_smoke.kernel_error(ring, q, k, v)["ok"]


def test_fsdp_and_tp_small_flux_match_the_replicated_forward(cuda_device):
    from comfyui_parallelanything_tpu_torch import ParallelConfig
    from comfyui_parallelanything_tpu_torch.parallel.mesh import (
        build_mesh,
        place_params_fsdp,
        place_params_tp,
    )
    from comfyui_parallelanything_tpu_torch.parallel.sharding import fsdp_replicas, tp_replicas

    g = torch.Generator(device=cuda_device).manual_seed(1)
    model = flux.build_flux(flux.flux_dev_config(**SMALL), device=cuda_device, generator=g)
    x = torch.randn(2, 16, 16, 4, generator=g, device=cuda_device)
    ctx = torch.randn(2, 8, 64, generator=g, device=cuda_device)
    y = torch.randn(2, 32, generator=g, device=cuda_device)
    t = torch.tensor([0.9, 0.4], device=cuda_device)
    gd = torch.full((2,), 3.5, device=cuda_device)
    with torch.no_grad():
        want = model.module(x, t, ctx, y=y, guidance=gd)
        placed = place_params_fsdp(model.module, build_mesh([cuda_device] * 2))
        fsdp = fsdp_replicas(model.module, placed)[1](x, t, ctx, y=y, guidance=gd)
        placed = place_params_tp(model.module, build_mesh([cuda_device] * 2,
                                                          {"data": 1, "model": 2}))
        tp = tp_replicas(model.module, placed)[0](x, t, ctx, y=y, guidance=gd)
    assert torch.equal(fsdp, want)
    assert chip_smoke.rel_l2(tp, want) <= chip_smoke.PARALLEL_REL_TOL
    pm = parallelize(model, [("cuda:0", 100)], ParallelConfig(weight_sharding="fsdp"))
    assert torch.equal(pm(x, t, ctx, y=y, guidance=gd), want)
    pm.cleanup()
