"""Parity of the PyTorch port's tokenizer, text encoders and text-checkpoint
converters against the JAX package on the CPU.

The same numpy weights (a flax tree made from a seed) go to both sides, the port
through ``convert_jax.from_jax_text_params``; the same token ids go in. Both run
in f32 (the JAX side under the suite's ``highest`` matmul precision) and must
agree to rtol/atol 2e-4. The converters are held to exact equality: a random
public-layout state dict through the JAX converter and ``from_jax_text_params``
against the port's converter on the same dict.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import convert_text as jct  # noqa: E402
from comfyui_parallelanything_tpu.models import text_encoders as jte  # noqa: E402
from comfyui_parallelanything_tpu.utils import tokenizer as jtok  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_text as pct  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import text_encoders as pte  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_text_params,
)
from comfyui_parallelanything_tpu_torch.utils import tokenizer as ptok  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
CLIP_SMALL = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4, max_len=16,
                  eos_id=99)
T5_SMALL = dict(vocab_size=100, d_model=64, num_layers=2, num_heads=4, d_kv=16, d_ff=128)


def _numpy_tree(abstract, seed):
    """Random numpy weights for an abstract flax tree: matrices N(0, 1/fan_in),
    vectors (biases, norm scales) off their init values, tables N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        scale = 0.1 if a.ndim == 1 else 1.0
        return (base + scale * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _pair(kind, seed=0, **overrides):
    if kind == "clip":
        jcfg = jte.CLIPTextConfig(**CLIP_SMALL, dtype=jnp.float32, **overrides)
        module, sample = jte.CLIPTextModel(jcfg), jnp.zeros((1, jcfg.max_len), jnp.int32)
        pcfg, build = pte.CLIPTextConfig(**CLIP_SMALL, dtype=torch.float32, **overrides), \
            pte.build_clip_text
        jbuild = jte.build_clip_text
    else:
        jcfg = jte.T5Config(**T5_SMALL, dtype=jnp.float32, **overrides)
        module, sample = jte.T5Encoder(jcfg), jnp.zeros((1, 8), jnp.int32)
        pcfg, build = pte.T5Config(**T5_SMALL, dtype=torch.float32, **overrides), \
            pte.build_t5_encoder
        jbuild = jte.build_t5_encoder
    abstract = jax.eval_shape(module.init, jax.random.key(0), sample)["params"]
    tree = _numpy_tree(abstract, seed)
    jenc = jbuild(jcfg, params=jax.tree.map(jnp.asarray, tree))
    penc = build(pcfg, device="cpu", state_dict=from_jax_text_params(tree))
    return jenc, penc, tree


def _tokens(seed, shape, vocab, eos=None):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab - 1, shape).astype(np.int32)
    if eos is not None:
        tokens[0, 5] = eos  # first EOS mid-row; the second row has none (argmax → 0)
        tokens[0, 9] = eos
    return tokens


class TestCLIP:
    @pytest.mark.parametrize(
        "overrides",
        [dict(), dict(act="gelu", projection_dim=32), dict(act="gelu", projection_dim=24,
                                                          penultimate_ln=True)],
        ids=["clip_l-quick_gelu", "open_clip-gelu-proj", "open_clip_h-penultimate_ln"],
    )
    def test_clip_matches_jax(self, overrides):
        jenc, penc, _ = _pair("clip", seed=1, **overrides)
        tokens = _tokens(2, (2, 16), CLIP_SMALL["vocab_size"], eos=CLIP_SMALL["eos_id"])
        want = jenc(jnp.asarray(tokens))
        got = penc(tokens)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_configs_match_jax(self):
        for name in ("clip_l_config", "open_clip_h_config", "open_clip_g_config",
                     "t5_xxl_config", "umt5_xxl_config"):
            j, p = getattr(jte, name)(), getattr(pte, name)()
            jd, pd = dataclasses.asdict(j), dataclasses.asdict(p)
            jd.pop("dtype"), pd.pop("dtype")
            assert jd == pd and p.dtype == torch.bfloat16, name

    def test_full_size_weights_and_dtypes(self):
        # Counted on the meta device: CLIP-L 123 M parameters, T5-XXL 4.76 B stored
        # in bf16 (9.5 GB) but for the f32 bias table and norm scales.
        with torch.device("meta"):
            clip = pte.CLIPTextModel(pte.clip_l_config())
            t5 = pte.T5Encoder(pte.t5_xxl_config())
        assert sum(p.numel() for p in clip.parameters()) == 123_060_480
        n = sum(p.numel() for p in t5.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in t5.parameters())
        assert n == 4_762_310_656 and nbytes == 2 * n + 2 * (32 * 64 + 49 * 4096)
        assert t5.rel_bias.dtype == torch.float32 and t5.blocks[0].ln1.weight.dtype == torch.float32
        assert t5.blocks[0].wi_0.weight.dtype == torch.bfloat16


class TestT5:
    @pytest.mark.parametrize("per_layer_bias", [False, True], ids=["t5", "umt5"])
    def test_t5_matches_jax_with_mask(self, per_layer_bias):
        jenc, penc, tree = _pair("t5", seed=3, per_layer_bias=per_layer_bias)
        assert ("rel_bias_1" in tree) == per_layer_bias
        tokens = _tokens(4, (2, 40), T5_SMALL["vocab_size"])  # 40 > 16: log buckets
        mask = np.ones((2, 40), np.int32)
        mask[1, 23:] = 0
        want = np.asarray(jenc(jnp.asarray(tokens), mask=jnp.asarray(mask)))
        got = penc(tokens, mask=mask)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        nomask = penc(tokens)
        np.testing.assert_allclose(nomask.numpy(), np.asarray(jenc(jnp.asarray(tokens))), **TOL)

    def test_relative_buckets_match_jax(self):
        pos = np.arange(300)
        rel = pos[None, :] - pos[:, None]
        want = np.asarray(jte._t5_relative_buckets(jnp.asarray(rel), 32, 128))
        got = pte._t5_relative_buckets(torch.from_numpy(rel), 32, 128)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_fully_masked_row_raises(self):
        # A row with no real token: both sides softmax over all -inf, so every query
        # of that row is NaN and the other rows are untouched.
        jenc, penc, _ = _pair("t5", seed=3)
        tokens = _tokens(5, (2, 8), T5_SMALL["vocab_size"])
        mask = np.ones((2, 8), np.int32)
        mask[1] = 0
        want = np.asarray(jenc(jnp.asarray(tokens), mask=jnp.asarray(mask)))
        got = penc(tokens, mask=mask).numpy()
        assert np.isnan(want[1]).all() and np.isfinite(want[0]).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got[0], want[0], **TOL)


def _hf_clip_layout(cfg, rng, prefix=""):
    w = cfg["hidden_size"]
    sd = {
        "text_model.embeddings.token_embedding.weight": (cfg["vocab_size"], w),
        "text_model.embeddings.position_embedding.weight": (cfg["max_len"], w),
        "text_model.final_layer_norm.weight": (w,), "text_model.final_layer_norm.bias": (w,),
        "text_projection.weight": (32, w),
    }
    for i in range(cfg["num_layers"]):
        t = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{t}.self_attn.{n}.weight"], sd[f"{t}.self_attn.{n}.bias"] = (w, w), (w,)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{t}.{n}.weight"], sd[f"{t}.{n}.bias"] = (w,), (w,)
        sd[f"{t}.mlp.fc1.weight"], sd[f"{t}.mlp.fc1.bias"] = (4 * w, w), (4 * w,)
        sd[f"{t}.mlp.fc2.weight"], sd[f"{t}.mlp.fc2.bias"] = (w, 4 * w), (w,)
    return {prefix + k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def _open_clip_layout(cfg, rng, prefix=""):
    w = cfg["hidden_size"]
    sd = {"token_embedding.weight": (cfg["vocab_size"], w),
          "positional_embedding": (cfg["max_len"], w), "ln_final.weight": (w,),
          "ln_final.bias": (w,), "text_projection": (w, 32)}
    for i in range(cfg["num_layers"]):
        t = f"transformer.resblocks.{i}"
        sd[f"{t}.attn.in_proj_weight"], sd[f"{t}.attn.in_proj_bias"] = (3 * w, w), (3 * w,)
        sd[f"{t}.attn.out_proj.weight"], sd[f"{t}.attn.out_proj.bias"] = (w, w), (w,)
        sd[f"{t}.mlp.c_fc.weight"], sd[f"{t}.mlp.c_fc.bias"] = (4 * w, w), (4 * w,)
        sd[f"{t}.mlp.c_proj.weight"], sd[f"{t}.mlp.c_proj.bias"] = (w, 4 * w), (w,)
        for n in ("ln_1", "ln_2"):
            sd[f"{t}.{n}.weight"], sd[f"{t}.{n}.bias"] = (w,), (w,)
    return {prefix + k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def _t5_layout(cfg, rng, per_layer_bias):
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    sd = {"shared.weight": (cfg["vocab_size"], d), "encoder.final_layer_norm.weight": (d,),
          "decoder.final_layer_norm.weight": (d,), "lm_head.weight": (cfg["vocab_size"], d)}
    for i in range(cfg["num_layers"]):
        t = f"encoder.block.{i}"
        if i == 0 or per_layer_bias:
            sd[f"{t}.layer.0.SelfAttention.relative_attention_bias.weight"] = (
                32, cfg["num_heads"])
        for n in "qkv":
            sd[f"{t}.layer.0.SelfAttention.{n}.weight"] = (inner, d)
        sd[f"{t}.layer.0.SelfAttention.o.weight"] = (d, inner)
        sd[f"{t}.layer.0.layer_norm.weight"] = (d,)
        sd[f"{t}.layer.1.layer_norm.weight"] = (d,)
        sd[f"{t}.layer.1.DenseReluDense.wi_0.weight"] = (ff, d)
        sd[f"{t}.layer.1.DenseReluDense.wi_1.weight"] = (ff, d)
        sd[f"{t}.layer.1.DenseReluDense.wo.weight"] = (d, ff)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def _assert_same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


class TestConvertText:
    @pytest.mark.parametrize("prefix", ["", "cond_stage_model.transformer."])
    def test_hf_clip_matches_jax_converter(self, prefix):
        sd = _hf_clip_layout(CLIP_SMALL, np.random.default_rng(5), prefix)
        jcfg = jte.CLIPTextConfig(**CLIP_SMALL, projection_dim=32)
        pcfg = pte.CLIPTextConfig(**CLIP_SMALL, projection_dim=32)
        want = from_jax_text_params(
            jax.tree.map(np.asarray, jct.convert_clip_text_checkpoint(sd, jcfg)))
        got = pct.convert_clip_text_checkpoint(sd, pcfg)
        _assert_same_state(got, want)
        pte.CLIPTextModel(pcfg).load_state_dict(got)  # every key of the module, no more

    def test_open_clip_matches_jax_converter_in_a_combined_checkpoint(self):
        rng = np.random.default_rng(6)
        sd = {**_hf_clip_layout(CLIP_SMALL, rng, "conditioner.embedders.0.transformer."),
              **_open_clip_layout(CLIP_SMALL, rng, "conditioner.embedders.1.model.")}
        kw = dict(CLIP_SMALL, act="gelu", projection_dim=32)
        want = from_jax_text_params(jax.tree.map(
            np.asarray, jct.convert_open_clip_checkpoint(sd, jte.CLIPTextConfig(**kw))))
        got = pct.convert_open_clip_checkpoint(sd, pte.CLIPTextConfig(**kw))
        _assert_same_state(got, want)
        pte.CLIPTextModel(pte.CLIPTextConfig(**kw)).load_state_dict(got)
        with pytest.raises(KeyError):
            pct.convert_open_clip_checkpoint(
                {"conditioner.embedders.1.model.positional_embedding": np.zeros((16, 64))},
                pte.CLIPTextConfig(**kw))

    @pytest.mark.parametrize("per_layer_bias", [False, True], ids=["t5", "umt5"])
    def test_t5_matches_jax_converter(self, per_layer_bias):
        sd = _t5_layout(T5_SMALL, np.random.default_rng(7), per_layer_bias)
        kw = dict(T5_SMALL, per_layer_bias=per_layer_bias)
        want = from_jax_text_params(jax.tree.map(
            np.asarray, jct.convert_t5_checkpoint(sd, jte.T5Config(**kw))))
        got = pct.convert_t5_checkpoint(sd, pte.T5Config(**kw))
        _assert_same_state(got, want)
        pte.T5Encoder(pte.T5Config(**kw)).load_state_dict(got)

    def test_low_precision_checkpoints_upcast(self):
        sd = _t5_layout(T5_SMALL, np.random.default_rng(8), False)
        half = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
        got = pct.convert_t5_checkpoint(half, pte.T5Config(**T5_SMALL))
        assert all(v.dtype == torch.float32 for v in got.values())


def _byte_tokenizers(**kw):
    """Both tokenizers over one vocab: every byte symbol alone and with ``</w>``,
    and a few merges (so BPE runs on ASCII, accented, CJK and emoji words)."""
    symbols = list(jtok._bytes_to_unicode().values())
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("c", "a"),
              ("ca", "t</w>"), ("Ã", "©"), ("æ", "ĳ")]
    vocab = {}
    for s in symbols + [s + "</w>" for s in symbols] + [a + b for a, b in merges]:
        vocab.setdefault(s, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return (jtok.CLIPBPETokenizer(vocab, merges, max_len=40, **kw),
            ptok.CLIPBPETokenizer(vocab, merges, max_len=40, **kw))


PROMPTS = [
    "Hello cat, it's 2 cats!",             # ASCII: contractions, digits, punctuation
    "  Café  crème brûlée  ",              # accented, whitespace runs
    "猫が好き 東京タワー",                    # CJK
    "🐱🚀 rocket-cat ❤️ x²½ Ⅻ",            # emoji, No/Nl numbers
    "naïve résumé — ½ ² ⅓ ①",
]


class TestTokenizer:
    @pytest.mark.parametrize("pad_id", [None, 0])
    def test_clip_bpe_matches_jax(self, pad_id):
        jt, pt = _byte_tokenizers(pad_id=pad_id)
        for text in PROMPTS:
            assert pt.encode(text) == jt.encode(text), text
        jids, jmask = jt(PROMPTS)
        pids, pmask = pt(PROMPTS)
        np.testing.assert_array_equal(pids, jids)
        np.testing.assert_array_equal(pmask, jmask)
        assert pids.dtype == np.int32

    @pytest.mark.parametrize("which", ["every_7th", "table"])
    def test_split_pattern_matches_regex_on_assigned_code_points(self, which):
        # Each code point between a letter and a digit, doubled, and after an
        # apostrophe: the stdlib pattern splits as the regex one. "every_7th" walks
        # the BMP and the first supplementary planes, assigned or not; "table" takes
        # every code point of utils/unicode_classes.py (letters and numbers newer
        # than Python's Unicode tables, and U+0345).
        from comfyui_parallelanything_tpu_torch.utils import unicode_classes as uc

        jt, pt = _byte_tokenizers()
        if which == "every_7th":
            cps = range(0, 0x30000, 7)
        else:
            cps = [cp for a, b in uc.LETTERS + uc.NUMBERS + uc.NO_CLASS
                   for cp in range(a, b + 1)]
            assert len(cps) == 9_662
        for cp in cps:
            ch = chr(cp)
            text = " ".join(f"a{ch}1 {ch}{ch} x '{ch}s".lower().split())
            assert pt._pat.findall(text) == jt._pat.findall(text), hex(cp)

    def test_json_tokenizer_matches_jax(self, tmp_path):
        tokenizers = pytest.importorskip("tokenizers")
        from tokenizers.models import WordLevel
        from tokenizers.pre_tokenizers import Whitespace

        t = tokenizers.Tokenizer(WordLevel({"[UNK]": 0, "hello": 1, "world": 2, "</s>": 5},
                                           unk_token="[UNK]"))
        t.pre_tokenizer = Whitespace()
        path = tmp_path / "tokenizer.json"
        t.save(str(path))
        for kw in (dict(max_len=6, eos_id=5), dict(max_len=3), dict(max_len=6, pad_id=7)):
            want = jtok.load_tokenizer_json(path, **kw)(["hello world", "world </s> hello x"])
            got = ptok.load_tokenizer_json(path, **kw)(["hello world", "world </s> hello x"])
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)


class TestSDXLConditioning:
    def test_sdxl_and_refiner_conditioning_match_jax(self):
        rng = np.random.default_rng(9)
        l_pen = rng.normal(size=(2, 7, 48)).astype(np.float32)
        g_pen = rng.normal(size=(2, 7, 64)).astype(np.float32)
        g_pool = rng.normal(size=(2, 16)).astype(np.float32)
        T = torch.from_numpy
        for kw in (dict(width=1024, height=768), dict(width=832, height=1216, crop_x=16,
                                                       crop_y=8, target_width=1024,
                                                       target_height=1024)):
            want = jte.sdxl_text_conditioning(jnp.asarray(l_pen), jnp.asarray(g_pen),
                                              jnp.asarray(g_pool), **kw)
            got = pte.sdxl_text_conditioning(T(l_pen), T(g_pen), T(g_pool), **kw)
            assert got[1].shape == (2, 16 + 6 * 256)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        # A bf16 tower output comes out f32, as the JAX helper casts it.
        ctx, _ = pte.sdxl_text_conditioning(T(l_pen).bfloat16(), T(g_pen), T(g_pool),
                                            width=64, height=64)
        assert ctx.dtype == torch.float32 and ctx.shape == (2, 7, 112)
        want = jte.sdxl_refiner_text_conditioning(jnp.asarray(g_pen), jnp.asarray(g_pool),
                                                  width=1024, height=1024, ascore=6.0, crop_x=4)
        got = pte.sdxl_refiner_text_conditioning(T(g_pen), T(g_pool), width=1024, height=1024,
                                                 ascore=6.0, crop_x=4)
        assert got[1].shape == (2, 16 + 5 * 256)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
