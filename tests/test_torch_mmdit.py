"""Parity of the PyTorch port's SD3 family against the JAX package on the CPU: the
MMDiT (``models/mmdit.py``) with ``convert_jax.from_jax_mmdit_params``, its SAI
checkpoint converter (``models/convert_mmdit.py``), ``sd3_text_conditioning`` and
``Sd3Pipeline``.

The same numpy weights (made from a seed for the JAX modules' abstract parameter
trees, no JAX ``init`` run) go to both sides; the same latents, timesteps,
contexts and pooled vectors go in. Configs are tiny (hidden 128/192, 64-wide
heads, a few blocks; the last block's context side is pre-only in every config).
Both sides run in f32 (the JAX side under the suite's ``highest`` matmul
precision) and must agree to rtol/atol 2e-4; the converters exactly. The MMDiT
inputs share the pipeline's CFG batch shapes, so JAX compiles each program once.
"""

import dataclasses
import functools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import pipelines as jpipe  # noqa: E402
from comfyui_parallelanything_tpu.models import convert_mmdit as jcm  # noqa: E402
from comfyui_parallelanything_tpu.models import mmdit as jm  # noqa: E402
from comfyui_parallelanything_tpu.models import text_encoders as jte  # noqa: E402
from comfyui_parallelanything_tpu.models import vae as jvae  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch import pipelines as ppipe  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_mmdit as pcm  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import mmdit as pm  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import text_encoders as pte  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import vae as pvae  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_mmdit_params,
    from_jax_text_params,
    from_jax_vae_params,
)
from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.tokenizer import CLIPBPETokenizer  # noqa: E402

from test_mmdit import _official_layout_sd  # noqa: E402
from test_tokenizer import _tiny_tokenizer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
# Context 48 wide: the CLIP-L ‖ G joint stream (16 + 24, zero-padded) and T5's
# d_model; pooled 8 + 16 (the towers' projections).
MMDIT = dict(in_channels=16, context_in_dim=48, pooled_dim=24, pos_embed_max=8)
CONFIGS = {
    "sd3_medium_like": dict(MMDIT, depth=2),
    "sd35_large_like": dict(MMDIT, depth=2, qk_norm=True),
    "sd35_medium_like": dict(MMDIT, depth=3, qk_norm=True, x_block_self_attn_layers=(0, 1)),
}
CLIP_L = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, max_len=8,
              projection_dim=8)
CLIP_G = dict(vocab_size=64, hidden_size=24, num_layers=2, num_heads=2, max_len=8,
              projection_dim=16, act="gelu")
T5 = dict(vocab_size=64, d_model=48, num_layers=2, num_heads=4, d_kv=8, d_ff=64)
VAE = dict(z_channels=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
           norm_groups=8, use_quant_conv=False, scaling_factor=1.5305, shift_factor=0.0609)
# Parameters of the JAX package's full-size MMDiTModel per config, counted from its
# abstract tree (jax.eval_shape of init): tracing the full-size modules takes
# longer than this file may.
JAX_PARAM_COUNTS = {"sd3_medium_config": 2_084_951_104, "sd35_large_config": 8_146_280_768,
                    "sd35_medium_config": 2_469_663_936}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy_tree(abstract, seed, conv=False):
    """Random weights for an abstract flax tree: kernels N(0, 1/fan_in) (``conv``:
    every kernel is a convolution's (kh, kw, in, out)), vectors and tables off their
    init values (q/k norm scales around one)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1])) if conv else a.shape[0]
            return jnp.asarray(rng.normal(size=a.shape) / np.sqrt(fan_in), jnp.float32)
        base = 1.0 if name in ("scale", "ln_q", "ln_k") else 0.0
        spread = 0.1 if a.ndim == 1 else 1.0
        return jnp.asarray(base + spread * rng.normal(size=a.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _abstract(module, *sample):
    return jax.eval_shape(module.init, jax.random.key(0), *sample)["params"]


def _inputs(seed, batch=2, hw=8, ctx_len=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, hw, hw, 16)).astype(np.float32)
    t = np.asarray([0.93, 0.41][:batch], np.float32)
    ctx = rng.normal(size=(batch, ctx_len, 48)).astype(np.float32)
    y = rng.normal(size=(batch, 24)).astype(np.float32)
    return x, t, ctx, y


@functools.cache
def _pair(name):
    """(JAX model, port model, numpy tree) for one of ``CONFIGS``, built once."""
    kw = CONFIGS[name]
    jcfg = jm.MMDiTConfig(**kw, dtype=jnp.float32)
    x, t, ctx, _ = _inputs(0, batch=1)
    tree = _np(_numpy_tree(_abstract(jm.MMDiTModel(jcfg), x, t, ctx), seed=len(name)))
    jmodel = jm.build_mmdit(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pmodel = pm.build_mmdit(pm.MMDiTConfig(**kw, dtype=torch.float32), device="cpu",
                            state_dict=from_jax_mmdit_params(tree))
    return jmodel, pmodel, tree


@functools.cache
def _jax_out(name, seed):
    jmodel, _, _ = _pair(name)
    x, t, ctx, y = _inputs(seed)
    return np.asarray(jmodel(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), y=jnp.asarray(y)))


def _port_out(pmodel, seed):
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs(seed))
    return pmodel(x, t, ctx, y=y)


class TestMMDiT:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_forward_matches_jax(self, name):
        _, pmodel, _ = _pair(name)
        got = _port_out(pmodel, 1)
        want = _jax_out(name, 1)
        assert got.shape == want.shape == (2, 8, 8, 16) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        blocks = pmodel.module.blocks
        assert [hasattr(b, "x_attn_in2") for b in blocks] == [
            i in pmodel.config.x_block_self_attn_layers for i in range(len(blocks))]
        assert [hasattr(b, "ctx_mlp_in") for b in blocks] == [True] * (len(blocks) - 1) + [False]
        assert hasattr(blocks[0].x_attn_in, "ln_q") == pmodel.config.qk_norm

    def test_staged_pipeline_spec_matches_forward(self):
        jmodel, pmodel, _ = _pair("sd35_medium_like")
        spec, jspec = pmodel.pipeline_spec, jmodel.pipeline_spec
        assert [s.label for s in spec.segments] == [s.label for s in jspec.segments]
        assert [s.param_keys for s in spec.segments] == [
            tuple(k.replace("_", ".") for k in s.param_keys) for s in jspec.segments]
        assert (spec.prepare_keys, spec.finalize_keys) == (jspec.prepare_keys,
                                                           jspec.finalize_keys)
        names = {n.split(".")[0] for n, _ in pmodel.module.named_parameters()}
        names |= {".".join(n.split(".")[:2]) for n, _ in pmodel.module.named_parameters()
                  if n.startswith("blocks.")}
        assert names - {"blocks"} == set(spec.prepare_keys) | set(spec.finalize_keys) | {
            k for s in spec.segments for k in s.param_keys}
        assert pmodel.block_lists == {"joint_blocks": 3}
        x, t, ctx, y = (torch.from_numpy(a) for a in _inputs(1))
        with torch.no_grad():
            carry = spec.prepare(pmodel.module, x, t, ctx, y=y)
            for seg in spec.segments:
                carry = seg.fn(pmodel.module, carry)
            staged = spec.finalize(pmodel.module, carry, tuple(x.shape))
        torch.testing.assert_close(staged, _port_out(pmodel, 1), rtol=0, atol=0)

    def test_position_table_crop_and_sincos_match_jax(self):
        for max_size, dim in ((8, 128), (5, 192)):
            np.testing.assert_array_equal(pm.sincos_pos_embed(max_size, dim),
                                          jm.sincos_pos_embed(max_size, dim))
        _, pmodel, tree = _pair("sd3_medium_like")
        table = tree["pos_embed"]["table"].reshape(8, 8, -1)
        got = pmodel.module._cropped_pos(4, 2)
        np.testing.assert_array_equal(got[0].detach().numpy(), table[2:6, 3:5].reshape(8, -1))
        with pytest.raises(ValueError, match="exceeds pos table 8x8"):
            pmodel.module._cropped_pos(9, 2)
        with pytest.raises(ValueError, match="requires text context"):
            pmodel(*(torch.from_numpy(a) for a in _inputs(1)[:2]))
        # A random model starts from the table SD3's checkpoints ship.
        rand = pm.build_mmdit(pm.MMDiTConfig(**CONFIGS["sd35_large_like"], dtype=torch.float32),
                              device="cpu", generator=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(rand.module.pos_embed.table.detach().numpy(),
                                      jm.sincos_pos_embed(8, 128))
        assert float(rand.module.blocks[0].x_attn_in.ln_q.detach().min()) == 1.0

    @pytest.mark.parametrize("name", ["sd3_medium_config", "sd35_large_config",
                                      "sd35_medium_config"])
    def test_configs_and_full_size_parameters_match_jax(self, name):
        jcfg, pcfg = getattr(jm, name)(), getattr(pm, name)()
        jd, pd = dataclasses.asdict(jcfg), dataclasses.asdict(pcfg)
        jd.pop("dtype"), pd.pop("dtype")
        assert jd == pd and pcfg.dtype == torch.bfloat16
        assert (pcfg.hidden_size, pcfg.num_heads, pcfg.head_dim) == (
            jcfg.hidden_size, jcfg.num_heads, 64)
        with torch.device("meta"):
            module = pm.MMDiTModel(pcfg)
        assert sum(p.numel() for p in module.parameters()) == JAX_PARAM_COUNTS[name]
        # The adaLN and final linears are held in f32, everything else in bf16.
        f32 = {n for n, p in module.named_parameters() if p.dtype == torch.float32}
        assert f32 == {n for n, _ in module.named_parameters()
                       if "adaln" in n or n.startswith("final_") or ".ln_" in n}

    @pytest.mark.parametrize("name,want", [
        ("sd35_large_config", {("sm90", (2, 4250, 38, 64), 4250): 38}),
        ("sd35_medium_config", {("sm90", (2, 4250, 24, 64), 4250): 24,
                                ("sm90", (2, 4096, 24, 64), 4096): 13}),
    ])
    def test_full_size_attention_takes_the_sm90_variant(self, monkeypatch, name, want):
        # A full-size forward at 1024² (128² latent, 64² tokens) with a 154-token
        # context (CLIP 77 ‖ T5 77), batch 2 (CFG), on the meta device: every
        # attention call's q/k/v as the MMDiT lays them out, through the variant
        # rule. The joint call concatenates the streams (contiguous); the x-only
        # call of a dual-attention block reads v as a strided view of the fused qkv.
        seen = Counter()

        def spy(q, k, v, scale=None):
            seen[(fa.kernel_variant(q, k, v, scale), tuple(q.shape), k.shape[1])] += 1
            return torch.empty_like(q)

        monkeypatch.setattr(pm, "attention", spy)
        cfg = getattr(pm, name)()
        with torch.device("meta"):
            module = pm.MMDiTModel(cfg)
            out = module(torch.empty(2, 128, 128, 16), torch.empty(2),
                         torch.empty(2, 154, 4096), y=torch.empty(2, 2048))
        assert out.shape == (2, 128, 128, 16)
        assert dict(seen) == want
        import chip_smoke

        held = {(variant, qshape, kshape[1]) for _, qshape, kshape, dtype_name, _, variant
                in chip_smoke.KERNEL_CASES if dtype_name == "bfloat16"}
        assert set(seen) <= held, set(seen) - held


class TestConverter:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_convert_mmdit_checkpoint_matches_jax(self, name):
        jmodel, pmodel, tree = _pair(name)
        sai = {f"model.diffusion_model.{k}": v
               for k, v in _official_layout_sd(jmodel.config, tree).items()}
        want = from_jax_mmdit_params(_np(jcm.convert_mmdit_checkpoint(sai, jmodel.config)))
        got = pcm.convert_mmdit_checkpoint(sai, pmodel.config)
        assert sorted(got) == sorted(want) == sorted(pmodel.module.state_dict())
        for k in want:
            assert got[k].dtype == torch.float32
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        # The converted weights give the JAX forward (the JAX round trip is bitwise).
        converted = pm.build_mmdit(pmodel.config, device="cpu", state_dict=got)
        np.testing.assert_allclose(_port_out(converted, 1).numpy(), _jax_out(name, 1), **TOL)
        assert pcm.strip_mmdit_prefix({"a.weight": 1}) == {"a.weight": 1}

    def test_strict_checks_raise_as_in_jax(self):
        jmodel, pmodel, tree = _pair("sd35_large_like")
        sai = _official_layout_sd(jmodel.config, tree)
        dual = dict(sai, **{"joint_blocks.0.x_block.attn2.qkv.weight": np.zeros((1, 1))})
        no_norm = {k: v for k, v in sai.items() if ".ln_" not in k}
        for sd, match in ((dual, "x_block_self_attn_layers"), (no_norm, "lacks q/k RMS-norm")):
            with pytest.raises(ValueError, match=match):
                jcm.convert_mmdit_checkpoint(sd, jmodel.config)
            with pytest.raises(ValueError, match=match):
                pcm.convert_mmdit_checkpoint(sd, pmodel.config)
        plain = pm.MMDiTConfig(**CONFIGS["sd3_medium_like"], dtype=torch.float32)
        with pytest.raises(ValueError, match="has q/k RMS-norm"):
            pcm.convert_mmdit_checkpoint(sai, plain)


class TestSd3Conditioning:
    @pytest.mark.parametrize("with_t5", [True, False], ids=["t5", "clip-only"])
    def test_matches_jax(self, with_t5):
        rng = np.random.default_rng(7)
        pen_l, pen_g = rng.normal(size=(2, 7, 16)), rng.normal(size=(2, 7, 24))
        pooled_l, pooled_g = rng.normal(size=(2, 8)), rng.normal(size=(2, 16))
        t5 = rng.normal(size=(2, 5, 48)) if with_t5 else None
        args = [a.astype(np.float32) for a in (pen_l, pen_g, pooled_l, pooled_g)]
        t5 = None if t5 is None else t5.astype(np.float32)
        want = jte.sd3_text_conditioning(*map(jnp.asarray, args),
                                         None if t5 is None else jnp.asarray(t5), context_dim=48)
        got = pte.sd3_text_conditioning(*map(torch.from_numpy, args),
                                        None if t5 is None else torch.from_numpy(t5),
                                        context_dim=48)
        assert got[0].shape == ((2, 12, 48) if with_t5 else (2, 7, 48))
        assert got[1].shape == (2, 24)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_overwide_clip_raises(self):
        wide = torch.ones((1, 7, 30))
        with pytest.raises(ValueError, match="CLIP joint width 60 exceeds 48"):
            pte.sd3_text_conditioning(wide, wide, torch.ones((1, 30)), torch.ones((1, 30)),
                                      context_dim=48)


@pytest.fixture(scope="module")
def sd3_pipes():
    jtok = _tiny_tokenizer()
    ptok = CLIPBPETokenizer(jtok.vocab, sorted(jtok.ranks, key=jtok.ranks.get), max_len=8)
    f32 = dict(dtype=jnp.float32)
    cpu = dict(device="cpu")
    towers = {}
    for i, (name, kw) in enumerate((("clip", CLIP_L), ("clip_g", CLIP_G))):
        jcfg = jte.CLIPTextConfig(**kw, eos_id=jtok.eos_id, **f32)
        tree = _np(_numpy_tree(_abstract(jte.CLIPTextModel(jcfg), jnp.zeros((1, 8), jnp.int32)),
                               30 + i))
        towers[name] = (
            jte.build_clip_text(jcfg, params=jax.tree.map(jnp.asarray, tree)),
            pte.build_clip_text(pte.CLIPTextConfig(**kw, eos_id=ptok.eos_id,
                                                   dtype=torch.float32),
                                state_dict=from_jax_text_params(tree), **cpu))
    tcfg = jte.T5Config(**T5, **f32)
    t5_tree = _np(_numpy_tree(_abstract(jte.T5Encoder(tcfg), jnp.zeros((1, 8), jnp.int32)), 32))
    towers["t5"] = (jte.build_t5_encoder(tcfg, params=jax.tree.map(jnp.asarray, t5_tree)),
                    pte.build_t5_encoder(pte.T5Config(**T5, dtype=torch.float32),
                                         state_dict=from_jax_text_params(t5_tree), **cpu))
    vcfg = jvae.VAEConfig(**VAE, **f32)
    v_tree = _np(_numpy_tree(_abstract(jvae.AutoencoderKL(vcfg), jnp.zeros((1, 16, 16, 3))), 33,
                             conv=True))
    towers["vae"] = (jvae.build_vae(vcfg, params=jax.tree.map(jnp.asarray, v_tree)),
                     pvae.build_vae(pvae.VAEConfig(**VAE, dtype=torch.float32),
                                    state_dict=from_jax_vae_params(v_tree), **cpu))
    jdit, pdit, _ = _pair("sd35_large_like")
    j = {k: v[0] for k, v in towers.items()}
    p = {k: v[1] for k, v in towers.items()}
    jp = jpipe.Sd3Pipeline(dit=jdit, tokenizer=jtok, t5_tokenizer=jtok, **j)
    pp = ppipe.Sd3Pipeline(dit=parallelize(pdit, [("cpu", 100)]), tokenizer=ptok,
                           t5_tokenizer=ptok, **p)
    return jp, pp


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's initial noise replaced by JAX's draw from key(0) (the JAX
    pipeline's default) at the requested shape."""
    def patched(shape, generator, device):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.key(0), shape,
                                                           jnp.float32))).to(device)

    monkeypatch.setattr(ppipe, "initial_noise", patched)


class TestSd3Pipeline:
    @pytest.mark.parametrize("kw", [dict(cfg_scale=1.0), dict(cfg_scale=4.5)],
                             ids=["no-cfg", "true-cfg"])
    def test_prompt_to_image_matches_jax(self, sd3_pipes, jax_noise, kw):
        jp, pp = sd3_pipes
        want = np.asarray(jp("hello world", "world", steps=2, height=16, width=16, **kw))
        got = pp("hello world", "world", steps=2, height=16, width=16, **kw)
        assert got.shape == (1, 16, 16, 3) and got.dtype == torch.float32
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_encode_prompt_joins_clip_and_t5(self, sd3_pipes):
        jp, pp = sd3_pipes
        want = jp.encode_prompt(["hello"])
        got = pp.encode_prompt(["hello"])
        assert got[0].shape == (1, 16, 48) and got[1].shape == (1, 24)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_contracts(self, sd3_pipes):
        _, pp = sd3_pipes
        with pytest.raises(ValueError, match="multiples of 4"):
            pp("hello", steps=1, height=14, width=16)
        with pytest.raises(ValueError, match="denoise < 1"):
            pp("hello", steps=1, height=16, width=16, denoise=0.5)
        with pytest.raises(ValueError, match="requires init_image"):
            pp("hello", steps=1, height=16, width=16, mask=np.ones((1, 16, 16)))
        with pytest.raises(ValueError, match="t5_tokenizer"):
            dataclasses.replace(pp, t5_tokenizer=None).encode_prompt(["hello"])

    def test_compile_loop_names_the_compiled_sampler_item(self, sd3_pipes):
        # The whole-loop compiled sampler is ported: for both sampler families the
        # pipeline's compile_loop=True runs it (on the CPU, the same loop body
        # uncaptured) and gives the eager pipeline's image.
        _, pp = sd3_pipes
        for sampler in ("flow_euler", "euler"):
            kw = dict(steps=1, height=16, width=16, sampler=sampler)
            np.testing.assert_array_equal(pp("hello", compile_loop=True, **kw).numpy(),
                                          pp("hello", **kw).numpy())
