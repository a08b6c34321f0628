"""The port's flash-attention kernel K1 (``ops/kernels/flash_attention.py``).

On the CPU the wrapper computes its plain version, which is held against the JAX
package's Pallas kernel in interpret mode on the cases of the JAX kernel's own
tests (rtol/atol 2e-4 in f32). The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.ops.pallas.flash_attention import (  # noqa: E402
    flash_attention as jax_flash,
)
from comfyui_parallelanything_tpu_torch.ops.kernels import build  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]


@pytest.mark.parametrize(
    "b,sq,sk,h,d,block",
    [
        (1, 64, 64, 2, 32, 128),
        (1, 100, 80, 2, 32, 128),
        (1, 300, 513, 2, 32, 128),
        (2, 128, 128, 2, 40, 64),     # head dim padded to 128 lanes on the TPU side
        (1, 128, 1024, 1, 32, 64),    # 16 streamed key blocks
        (1, 100, 80, 2, 160, 64),     # SD1.5's deepest head dim, padded to 256 lanes
        (1, 70, 130, 1, 512, 64),     # the VAE mid-block's one 512-wide head
    ],
)
def test_plain_matches_pallas_interpret(b, sq, sk, h, d, block):
    q, k, v = _qkv(sq + sk + d, b, sq, sk, h, d)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=block, block_k=block,
                     interpret=True)
    launches = fa.launches
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert fa.launches == launches  # the CPU path launches nothing
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_bf16_keeps_dtype_and_scale_override():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 32, 48, 2, 16))
    got = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale=0.1)
    assert got.dtype == torch.bfloat16
    want = fa.flash_attention_plain(q, k, v, scale=0.1)
    # bf16 inputs and output: ~3 significant digits.
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("head_dim", [128, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_check_rejects_planted_tail_bugs(dtype, head_dim):
    # The limits the card's smoke run holds K1 to accept the plain version's own
    # rounding to ``dtype`` and reject a kernel that leaves the padded keys of the
    # last 64-key block unmasked or drops the last key (300 queries, 513 keys), at
    # the FLUX head dim and the VAE's.
    import chip_smoke

    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(11, 1, 300, 513, 2, head_dim))
    assert chip_smoke.kernel_error(fa.flash_attention_plain(q, k, v), q, k, v)["ok"]
    bugs = chip_smoke.tail_bugs(q, k, v)
    assert set(bugs) == {"tail_unmasked", "last_key_dropped"}
    for bug, out in bugs.items():
        assert not chip_smoke.kernel_error(out.to(dtype), q, k, v)["ok"], bug


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, torch.zeros(1, 9, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], q[0], q[0])


def test_build_is_keyed_by_source_and_outside_the_package():
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libflash_attention-")
    assert all((build.CSRC_DIR / unit).exists() for unit in build.SOURCES["flash_attention"])
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def _flux_single_block_v(seq, dtype=torch.bfloat16, heads=24, head_dim=128):
    # As in models/flux.py's SingleBlock: linear1's fused output, split into qkv and
    # the MLP input, qkv reshaped to (B, S, 3, H, D); v is the third slice.
    hidden = heads * head_dim
    fused = torch.empty((1, seq, 3 * hidden + 4 * hidden), dtype=dtype)
    qkv = fused[..., : 3 * hidden]
    return qkv.reshape(1, seq, 3, heads, head_dim)[:, :, 2]


def _unaligned(shape, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    return torch.empty(n + 1, dtype=dtype)[1:].view(shape)  # 2 bytes past an aligned start


@pytest.mark.parametrize(
    "case,want",
    [
        ("flux_bf16", "sm90"),
        ("flux_f16", "sm90"),
        ("single_block_strided_v", "sm90"),
        ("d40", "sm90"),
        ("d64", "sm90"),
        ("d8", "sm90"),
        ("d136", "wide"),
        ("d160", "wide"),
        ("d256", "wide"),
        ("d264", "wide"),
        ("d320", "wide"),
        ("d512", "wide"),
        ("d130", "mma"),   # head dim not a multiple of 8: TMA cannot take it
        ("d260", "d512"),
        ("d1024", None),  # no variant: head dims above 512 go to the xla family
        ("unaligned_offset", "mma"),
        ("unaligned_d160", "mma"),
        ("unaligned_d512", "d512"),
        ("negative_scale", "mma"),
        ("negative_scale_d512", "d512"),
        ("f32", "tf32x3"),  # every aligned float32 call up to D=256: test_float32_variant_rule
        ("f64", None),
        ("strided_head_dim", None),
    ],
)
def test_kernel_variant_rule(case, want):
    flux = (1, 4608, 24, 128)
    scale = None
    if case in ("flux_bf16", "flux_f16"):
        dtype = torch.bfloat16 if case == "flux_bf16" else torch.float16
        q = k = v = torch.empty(flux, dtype=dtype)
    elif case == "single_block_strided_v":
        v = _flux_single_block_v(16)
        assert v.stride(1) == 21504 and v.storage_offset() == 6144
        q = k = torch.empty((1, 16, 24, 128), dtype=torch.bfloat16)
    elif case.startswith("d"):
        d = int(case[1:])
        q = k = v = torch.empty((2, 30, 4, d), dtype=torch.bfloat16)
    elif case.startswith("unaligned"):
        d = int(case.removeprefix("unaligned_d")) if case != "unaligned_offset" else 128
        q = k = torch.empty((2, 30, 4, d), dtype=torch.bfloat16)
        v = _unaligned((2, 30, 4, d))
        assert v.data_ptr() % 16 != 0
    elif case.startswith("negative_scale"):
        d = 512 if case.endswith("d512") else 128
        q = k = v = torch.empty((2, 30, 4, d), dtype=torch.bfloat16)
        assert fa.kernel_variant(q, k, v, 0.1) == ("sm90" if d == 128 else "wide")
        assert fa.kernel_variant(q, k, v, 0.0) == want
        scale = -0.1
    elif case == "strided_head_dim":
        q = k = v = torch.empty((2, 30, 128, 4), dtype=torch.bfloat16).transpose(2, 3)
    else:
        dtype = torch.float32 if case == "f32" else torch.float64
        q = k = v = torch.empty((2, 30, 4, 128), dtype=dtype)
    assert fa.kernel_variant(q, k, v, scale) == want


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("d", [4, 8, 40, 64, 80, 100, 128, 160, 164, 252, 256])
def test_float32_variant_rule_takes_tf32x3(d):
    # Aligned float32 calls with head dims 4..256 (multiples of 4) go to tf32x3, as
    # the UNets' and FLUX's float32 calls do (40, 64, 80, 128, 160); the rule answers
    # on meta tensors.
    q = k = v = _meta((2, 30, 4, d))
    assert fa.kernel_variant(q, k, v) == "tf32x3"
    assert fa.kernel_variant(q, k, v, 0.05) == "tf32x3"
    # The FLUX single block's strided v, in float32.
    fused = _meta((1, 16, 7 * 4 * d))
    v = fused[..., : 3 * 4 * d].reshape(1, 16, 3, 4, d)[:, :, 2]
    q = k = _meta((1, 16, 4, d))
    assert fa.kernel_variant(q, k, v) == "tf32x3"


@pytest.mark.parametrize(
    "case,want",
    [
        ("unaligned_offset", "f32"),   # 4 bytes past an aligned start
        ("odd_stride", "f32"),         # a sequence stride of 130 floats (520 bytes)
        ("d130", "f32"),               # head dim not a multiple of 4
        ("d42", "f32"),
        ("d260", "f32"),               # head dims in (256, 512]
        ("d320", "f32"),
        ("d512", "f32"),
        ("zero_scale", "f32"),         # a non-positive scale
        ("negative_scale", "f32"),
        ("d520", None),                # what no variant took before takes none now
        ("strided_head_dim", None),
    ],
)
def test_float32_variant_rule_keeps_f32_for_what_tf32x3_cannot_take(case, want):
    scale = None
    if case == "unaligned_offset":
        q = k = _meta((2, 30, 4, 128))
        v = torch.empty(2 * 30 * 4 * 128 + 1, device="meta")[1:].view(2, 30, 4, 128)
        assert v.data_ptr() % 16 == 4
    elif case == "odd_stride":
        q = k = _meta((2, 30, 4, 128))
        v = _meta((2, 30, 4, 130))[..., :128]
        assert v.stride(2) == 130
    elif case.startswith("d"):
        q = k = v = _meta((2, 30, 4, int(case[1:])))
    elif case.endswith("scale"):
        q = k = v = _meta((2, 30, 4, 128))
        scale = 0.0 if case == "zero_scale" else -0.1
    else:
        q = k = v = _meta((2, 30, 128, 4)).transpose(2, 3)
    assert fa.kernel_variant(q, k, v, scale) == want


def _tf32(x):
    # What the tensor cores read from a raw f32 word as a TF32 operand: the word with
    # its low 13 mantissa bits cut off (truncation, as chip_smoke's probe checks).
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32x3(a, b, passes=3):
    # a @ b as tf32x3 takes it: each operand's raw word is its hi (read as tf32(x))
    # and lo = x - tf32(x) (exact, read as tf32(lo)); the products
    # a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the small ones first, each TF32 product exact
    # in f32 and summed in f32; a_lo·b_lo dropped. One pass is plain TF32 (a_hi·b_hi).
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _attention_tf32x3(q, k, v, passes=3):
    # The kernel's arithmetic on (B, S, H, D): S in tf32x3, the softmax in f32 on
    # exp2 with the scale folded in after the max, P split as the operands are, and
    # O divided by the row sum at the end.
    scale_log2 = q.shape[-1] ** -0.5 * 1.4426950408889634
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = _mm_tf32x3(qt, kt.transpose(-1, -2), passes)
    m = s.amax(-1, keepdim=True) * scale_log2
    p = torch.exp2(s * scale_log2 - m)
    o = _mm_tf32x3(p, vt, passes) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


@pytest.mark.parametrize("d", [128, 40, 160])
def test_tf32x3_arithmetic_holds_the_f32_limits(d):
    # Before any card: the split tf32x3 uses (hi and lo truncated to TF32) keeps the
    # kernel inside chip_smoke's unchanged float32 limits at the smoke run's f32 case
    # shape, and at SD1.5's head dims 40 and 160; plain TF32 (one pass) does not.
    import chip_smoke

    q, k, v = (torch.from_numpy(a) for a in _qkv(d, 2, 300, 513, 4, d))
    res = chip_smoke.kernel_error(_attention_tf32x3(q, k, v), q, k, v)
    assert res["ok"], res
    assert res["rel_l2_err"] < chip_smoke.KERNEL_LIMITS["float32"][2] / 4, res
    assert not chip_smoke.kernel_error(_attention_tf32x3(q, k, v, passes=1), q, k, v)["ok"]


def test_variant_counts_reset_and_cpu_path_launches_nothing():
    fa.reset_launches()
    assert fa.launches == 0 and fa.launches_by_variant == dict.fromkeys(fa.VARIANTS, 0)
    q = torch.zeros(1, 8, 2, 16)
    fa.flash_attention(q, q, q)
    assert fa.launches == 0 and sum(fa.launches_by_variant.values()) == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa._launch(q.to("meta"), q.to("meta"), q.to("meta"), 0.25, "sm90")


def test_build_key_covers_headers_and_link_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = [p.name for p in build.sources_of("flash_attention")]
    assert names[0] == "flash_attention.cu"
    assert {"flash_attention_sm90.cuh", "hopper.cuh"} <= set(names)
    before = build.library_path("flash_attention")
    # hopper.cuh is included only through flash_attention_sm90.cuh.
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build.library_path("flash_attention")
    assert edited != before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.COMPILE_FLAGS + ("-shared", "-lm"))
    assert build.library_path("flash_attention") not in (before, edited)


_SD15_CALLS = {((2, 4096, 8, 40), 4096): 5, ((2, 4096, 8, 40), 77): 5,
               ((2, 1024, 8, 80), 1024): 5, ((2, 1024, 8, 80), 77): 5,
               ((2, 256, 8, 160), 256): 5, ((2, 256, 8, 160), 77): 5}


@pytest.mark.parametrize(
    "name,dtype,hw,want",
    [("sdxl_config", torch.bfloat16, 128, {("sm90", (2, 4096, 10, 64), 4096): 10,
                                           ("sm90", (2, 4096, 10, 64), 77): 10,
                                           ("sm90", (2, 1024, 20, 64), 1024): 60,
                                           ("sm90", (2, 1024, 20, 64), 77): 60}),
     ("sd15_config", torch.bfloat16, 64,
      {("wide" if q[-1] == 160 else "sm90", q, sk): n for (q, sk), n in _SD15_CALLS.items()}),
     ("sd15_config", torch.float32, 64,
      {("tf32x3", q, sk): n for (q, sk), n in _SD15_CALLS.items()})],
    ids=["sdxl-1024", "sd15-512", "sd15-512-f32"],
)
def test_full_size_unet_attention_takes_the_expected_variants(monkeypatch, name, dtype, hw,
                                                              want):
    # A full-size UNet forward at batch 2 (CFG) on the meta device: shapes and
    # strides only, no memory. Every attention call's q/k/v as the UNet lays them
    # out, through the variant rule: SDXL at 1024² makes 140 calls, all sm90;
    # SD1.5 at 512² makes 20 sm90 (head dims 40, 80) and 10 wide (160) calls, with
    # no middle transformer (the JAX package's middle_depth gives it none), and in
    # float32 30 tf32x3 calls.
    from collections import Counter

    from comfyui_parallelanything_tpu_torch.models import unet

    seen = Counter()

    def spy(q, k, v, scale=None):
        seen[(fa.kernel_variant(q, k, v, scale), tuple(q.shape), k.shape[1])] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(unet, "attention", spy)
    cfg = getattr(unet, name)(dtype=dtype)
    with torch.device("meta"):
        module = unet.UNet2D(cfg)
        kw = {"y": torch.empty(2, cfg.adm_in_channels)} if cfg.adm_in_channels else {}
        out = module(torch.empty(2, hw, hw, 4), torch.empty(2), torch.empty(2, 77, cfg.context_dim),
                     **kw)
    assert out.shape == (2, hw, hw, 4)
    assert dict(seen) == want
    # The card's smoke run holds K1 against its plain version at each of these
    # calls: a contiguous KERNEL_CASES row in the same dtype with the same variant and
    # shapes.
    import chip_smoke

    held = {(variant, qshape, kshape[1]) for _, qshape, kshape, dtype_name, layout, variant
            in chip_smoke.KERNEL_CASES
            if f"torch.{dtype_name}" == str(dtype) and layout == "contiguous"}
    assert set(seen) <= held, set(seen) - held


@pytest.mark.parametrize("name", ["flux_vae_config", "sdxl_vae_config"])
def test_full_size_vae_attention_takes_the_wide_variant(monkeypatch, name):
    # A full-size kl-f8 VAE at 1024² on the meta device: its encoder's and its
    # decoder's mid-block attention are each one (1, 16384, 1, 512) call, laid out
    # as the VAE lays it out, which the rule sends to the wide variant. The card's
    # smoke run holds K1 against its plain version at that call (vae_1024_d512).
    from collections import Counter

    from comfyui_parallelanything_tpu_torch.models import vae

    seen = Counter()

    def spy(q, k, v, scale=None):
        seen[(fa.kernel_variant(q, k, v, scale), tuple(q.shape), k.shape[1])] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(vae, "attention_local", spy)
    cfg = getattr(vae, name)()
    with torch.device("meta"):
        module = vae.AutoencoderKL(cfg)
        z = module.encode(torch.empty(1, 1024, 1024, 3, dtype=cfg.dtype))
        out = module.decode(z)
    assert z.shape == (1, 128, 128, cfg.z_channels) and out.shape == (1, 1024, 1024, 3)
    assert dict(seen) == {("wide", (1, 16384, 1, 512), 16384): 2}
    import chip_smoke

    assert ("vae_1024_d512", (1, 16384, 1, 512), (1, 16384, 1, 512), "bfloat16", "contiguous",
            "wide") in chip_smoke.KERNEL_CASES


def test_auto_routes_what_no_variant_takes_to_xla():
    # ops/attention.py's auto sends a call to K1 only on CUDA and only where
    # kernel_takes holds (where kernel_variant names a variant); the rule answers on
    # meta tensors, without a card. A direct flash_attention call keeps its ValueError (on CUDA; see
    # tests/test_torch_cuda.py).
    from comfyui_parallelanything_tpu_torch.ops import attention

    def meta(d, dtype=torch.bfloat16):
        return torch.empty((1, 64, 2, d), dtype=dtype, device="meta")

    assert not fa.kernel_takes(meta(520), meta(520), meta(520))
    assert fa.kernel_variant(meta(520), meta(520), meta(520)) is None
    assert fa.kernel_variant(meta(64, torch.float64), meta(64, torch.float64),
                             meta(64, torch.float64)) is None
    assert fa.kernel_variant(meta(512), meta(512), meta(512)) == "wide"
    assert fa.kernel_variant(meta(64), meta(64), meta(64)) == "sm90"
    # On the CPU every call takes the xla family, whatever its head dim or dtype.
    attention._RESOLVED.clear()
    q = torch.from_numpy(_qkv(3, 1, 16, 16, 2, 520)[0]).double()
    got = attention.attention_local(q, q, q)
    assert attention.resolved_backends() == ("xla",)
    want = attention._xla_attention(q, q, q, 520 ** -0.5)
    torch.testing.assert_close(got, want)
