"""The PyTorch port's checkpoint loaders (``models/loader.py``) and parameter
save/restore (``models/checkpoint.py``) against the JAX package's, on the CPU.

- The port's own safetensors reader against files written by the ``safetensors``
  package: every dtype it maps bitwise, ``peek`` from the header alone, ``subset``
  from its prefixes alone, and a ``ValueError`` for a truncated or malformed file.
- ``sniff_model_family`` and ``sniff_vae_config`` on the key signatures of each
  family, against JAX's.
- Each ``load_*`` against JAX's loader on the same public-layout dict: the port's
  loaded weights equal the JAX loader's carried across by ``convert_jax`` (the
  forwards of equal weights are held by each family's own parity file), and the
  FLUX loader, read from a file with fp8 blocks and a LoRA stack, also forward.
"""

import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
safetensors_torch = pytest.importorskip("safetensors.torch")

import jax  # noqa: E402

from comfyui_parallelanything_tpu.models import loader as jload  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import checkpoint as pckpt  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_jax as cj  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as pload  # noqa: E402

DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn,
          torch.float8_e5m2, torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool]


def _raw(t):
    return t.reshape(-1).view(torch.uint8) if t.numel() and t.dtype != torch.bool else t


def _save(path, tensors):
    safetensors_torch.save_file(tensors, str(path))
    return path


def _jnp_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same_state(got: dict, want: dict, tol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


class TestSafetensorsReader:
    @pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
    def test_reads_every_mapped_dtype_bitwise(self, tmp_path, dtype):
        g = torch.Generator().manual_seed(DTYPES.index(dtype))
        src = torch.randn(3, 5, generator=g) * 40
        tensors = {"a": src.to(dtype), "scalar": src[0, 0].to(dtype).clone(),
                   "empty": torch.zeros((0, 4), dtype=dtype)}
        got = pload.load_safetensors(_save(tmp_path / "t.safetensors", tensors))
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape
            assert torch.equal(_raw(got[k]), _raw(t)), k

    def test_peek_and_subset_read_only_what_they_need(self, tmp_path):
        tensors = {"a.x": torch.arange(6.0).reshape(2, 3), "b.y": torch.ones(4, dtype=torch.float16)}
        path = _save(tmp_path / "t.safetensors", tensors)
        cut = tmp_path / "cut.safetensors"
        cut.write_bytes(path.read_bytes()[:-4])  # b.y, stored after a.x, loses its end
        peek = pload.peek_safetensors(cut)
        assert {k: (v.shape, v.dtype) for k, v in peek.items()} == {
            "a.x": ((2, 3), torch.float32), "b.y": ((4,), torch.float16)}
        assert pload.sniff_model_family({"double_blocks.0.x": peek["a.x"]}) == "zimage-turbo"
        sub = pload.load_safetensors_subset(cut, "a.")
        assert list(sub) == ["a.x"] and torch.equal(sub["a.x"], tensors["a.x"])
        with pytest.raises(ValueError, match="truncated"):
            pload.load_safetensors(cut)
        with pytest.raises(ValueError, match="truncated"):
            pload.load_safetensors_subset(cut, "b.")

    def test_malformed_files_raise(self, tmp_path):
        import json
        import struct

        def write(name, header, data=b""):
            text = json.dumps(header).encode()
            (tmp_path / name).write_bytes(struct.pack("<Q", len(text)) + text + data)
            return tmp_path / name

        with pytest.raises(ValueError, match="unsupported safetensors dtype"):
            pload.load_safetensors(write("c.st", {"z": {"dtype": "C64", "shape": [1],
                                                         "data_offsets": [0, 8]}}, bytes(8)))
        with pytest.raises(ValueError, match="bytes for shape"):
            pload.load_safetensors(write("o.st", {"z": {"dtype": "F32", "shape": [3],
                                                         "data_offsets": [0, 8]}}, bytes(8)))
        (tmp_path / "s.st").write_bytes(b"\x10\x00")
        with pytest.raises(ValueError, match="8-byte"):
            pload.load_safetensors(tmp_path / "s.st")
        (tmp_path / "h.st").write_bytes(struct.pack("<Q", 100) + b"{}")
        with pytest.raises(ValueError, match="header"):
            pload.peek_safetensors(tmp_path / "h.st")
        with pytest.raises(TypeError):
            pload._resolve_state_dict(3)


def _stub(**shapes):
    return {k.replace("__", "."): types.SimpleNamespace(shape=s) for k, s in shapes.items()}


def _ldm_unet(ctx, in_ch=4, label=False, first_attn=None):
    keys = {"input_blocks.0.0.weight": (320, in_ch, 3, 3),
            "input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight": (320, ctx)}
    if first_attn is not None:
        del keys["input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"]
        keys["input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight"] = (640, first_attn)
    if label:
        keys["label_emb.0.0.weight"] = (1280, 2816)
    return {k: types.SimpleNamespace(shape=s) for k, s in keys.items()}


def _blocks(prefix, n, extra=()):
    keys = {f"{prefix}.{i}.x.weight": (4, 4) for i in range(n)}
    keys.update({k: (4, 4) for k in extra})
    return {k: types.SimpleNamespace(shape=s) for k, s in keys.items()}


FAMILIES = {
    "flux-dev": _blocks("double_blocks", 19, ["guidance_in.in_layer.weight"]),
    "flux-schnell": _blocks("double_blocks", 19),
    "zimage-turbo": _blocks("double_blocks", 6),
    "sd35-medium": _blocks("joint_blocks", 24, ["joint_blocks.0.x_block.attn2.qkv.weight"]),
    "sd35-large": _blocks("joint_blocks", 38),
    "sd3-medium": _blocks("joint_blocks", 24),
    "wan-14b": _stub(blocks__0__self_attn__q__weight=(5120, 5120)),
    "wan-1.3b": _stub(blocks__0__cross_attn__q__weight=(1536, 1536)),
    "sd15": _ldm_unet(768),
    "sd21": _ldm_unet(1024),
    "sd15-inpaint": _ldm_unet(768, in_ch=9),
    "sd21-inpaint": _ldm_unet(1024, in_ch=9),
    "sd21-unclip": _ldm_unet(1024, label=True),
    "sdxl": _ldm_unet(0, label=True, first_attn=2048),
    "sdxl-inpaint": _ldm_unet(0, in_ch=9, label=True, first_attn=2048),
    "sdxl-refiner": _ldm_unet(0, label=True, first_attn=1280),
    "full-checkpoint-prefix": {f"model.diffusion_model.{k}": v
                               for k, v in _ldm_unet(768).items()},
    "inpaint-unknown-width": _ldm_unet(640, in_ch=9),
    "no-signature": _stub(foo__weight=(1, 1)),
}


class TestSniff:
    @pytest.mark.parametrize("name", list(FAMILIES))
    def test_model_family_matches_jax(self, name):
        sd = FAMILIES[name]
        try:
            want = jload.sniff_model_family(sd)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                pload.sniff_model_family(sd)
            return
        assert pload.sniff_model_family(sd) == want
        if name in ("flux-dev", "sd15", "sdxl"):
            assert want == name

    @pytest.mark.parametrize("z,prefix", [(16, ""), (4, "first_stage_model."), (4, "vae.")])
    def test_vae_config_matches_jax(self, z, prefix):
        sd = {f"{prefix}decoder.conv_in.weight": np.zeros((8, z, 3, 3), np.float32),
              f"{prefix}decoder.conv_out.weight": np.zeros((3, 8, 3, 3), np.float32)}
        want, got = jload.sniff_vae_config(sd), pload.sniff_vae_config(sd)
        assert (got.z_channels, got.scaling_factor, got.shift_factor) == (
            want.z_channels, want.scaling_factor, want.shift_factor)
        with pytest.raises(KeyError):
            pload.sniff_vae_config({"encoder.conv_in.weight": sd[f"{prefix}decoder.conv_in.weight"]})


class TestLoaders:
    def test_flux_from_a_file_with_fp8_blocks_and_a_lora_stack(self, tmp_path):
        from test_torch_convert import _cfgs, _inputs, _jax_forward, _sd, kohya_lora

        jcfg, pcfg = _cfgs()
        sd = _sd()
        l1, l2 = kohya_lora(sd, seed=1), kohya_lora(sd, seed=2, peft=True)
        path = _save(tmp_path / "flux.safetensors", {k: v.contiguous() for k, v in sd.items()})
        lpath = _save(tmp_path / "lora.safetensors", l1)
        stack = [(str(lpath), 0.7), (l2, 0.4)]
        jm = jload.load_flux_checkpoint(sd, jcfg, lora=stack)
        pm = pload.load_flux_checkpoint(str(path), pcfg, lora=stack, device="cpu")
        assert pm.pipeline_spec is not None and pm.name == "flux"
        _same_state(pm.module.state_dict(), cj.from_jax_params(_jnp_tree(jm.params)), 1e-6)
        x, t, ctx, y = _inputs(2)
        want = _jax_forward(jm.params)(x, t, ctx, y=y)
        T = torch.from_numpy
        np.testing.assert_allclose(pm(T(x), T(t), T(ctx), y=T(y)).numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        plain = pload.load_flux_checkpoint(str(path), pcfg, device="cpu")
        _same_state(plain.module.state_dict(), pload.convert_flux_checkpoint(sd, pcfg))

    def test_sd_unet(self):
        import test_torch_unet as tu
        from test_convert_unet import _ldm_sd

        jm, pm, tree = tu._pair("sd15_like")
        ldm = {f"model.diffusion_model.{k}": v for k, v in _ldm_sd(jm.config, tree).items()}
        lora = {"lora_unet_time_embed_0.lora_down.weight": np.ones((1, 32), np.float32),
                "lora_unet_time_embed_0.lora_up.weight": np.ones((128, 1), np.float32)}
        want = jload.load_sd_unet_checkpoint(ldm, jm.config, lora=lora, lora_strength=0.5)
        got = pload.load_sd_unet_checkpoint(ldm, pm.config, lora=lora, lora_strength=0.5,
                                            device="cpu")
        _same_state(got.module.state_dict(), cj.from_jax_unet_params(_jnp_tree(want.params)),
                    1e-6)

    def test_controlnet_ldm_and_diffusers(self):
        import test_torch_controlnet as tc
        from test_controlnet import _diffusers_from_ldm, _ldm_controlnet_sd

        (jbase, pbase), _, trees = tc._nets()
        ldm = _ldm_controlnet_sd(jbase.config, trees[0])
        for sd in ({f"control_model.{k}": v for k, v in ldm.items()},
                   _diffusers_from_ldm(jbase.config, ldm)):
            want = jload.load_controlnet_checkpoint(sd, jbase.config)
            got = pload.load_controlnet_checkpoint(sd, pbase.config, device="cpu")
            _same_state(got.module.state_dict(),
                        cj.from_jax_unet_params(_jnp_tree(want.params)))

    def test_mmdit_aligns_its_config(self):
        import dataclasses

        import test_torch_mmdit as tm
        from test_mmdit import _official_layout_sd

        jm, pm, tree = tm._pair("sd35_medium_like")
        sai = {f"model.diffusion_model.{k}": v
               for k, v in _official_layout_sd(jm.config, tree).items()}
        generic = dict(x_block_self_attn_layers=(), qk_norm=False)
        want = jload.load_mmdit_checkpoint(sai, dataclasses.replace(jm.config, **generic))
        got = pload.load_mmdit_checkpoint(sai, dataclasses.replace(pm.config, **generic),
                                          device="cpu")
        assert got.config.x_block_self_attn_layers == want.config.x_block_self_attn_layers
        _same_state(got.module.state_dict(), cj.from_jax_mmdit_params(_jnp_tree(want.params)))

    def test_vae_clip_and_t5(self):
        from comfyui_parallelanything_tpu.models import text_encoders as jte
        from comfyui_parallelanything_tpu.models import vae as jvae
        from comfyui_parallelanything_tpu_torch.models import text_encoders as pte
        from comfyui_parallelanything_tpu_torch.models import vae as pvae

        import test_torch_text as tt
        import test_torch_vae as tv

        kw = tv.CONFIGS[sorted(tv.CONFIGS)[0]]
        sd = {f"first_stage_model.{k}": v
              for k, v in tv._ldm_layout(pvae.VAEConfig(**kw), seed=3).items()}
        want = jload.load_vae_checkpoint(sd, jvae.VAEConfig(**kw))
        got = pload.load_vae_checkpoint(sd, pvae.VAEConfig(**kw, dtype=torch.float32),
                                        device="cpu")
        _same_state(got.module.state_dict(), cj.from_jax_vae_params(_jnp_tree(want.params)))
        rng = np.random.default_rng(4)
        clip_kw = dict(tt.CLIP_SMALL, projection_dim=32)
        f32 = dict(dtype=torch.float32)
        for open_clip, layout in ((False, tt._hf_clip_layout), (True, tt._open_clip_layout)):
            sd = layout(tt.CLIP_SMALL, rng)
            want = jload.load_clip_text_checkpoint(sd, jte.CLIPTextConfig(**clip_kw),
                                                   open_clip=open_clip)
            got = pload.load_clip_text_checkpoint(sd, pte.CLIPTextConfig(**clip_kw, **f32),
                                                  open_clip=open_clip, device="cpu")
            _same_state(got.module.state_dict(),
                        cj.from_jax_text_params(_jnp_tree(want.params)))
        sd = tt._t5_layout(tt.T5_SMALL, rng, False)
        want = jload.load_t5_checkpoint(sd, jte.T5Config(**tt.T5_SMALL))
        got = pload.load_t5_checkpoint(sd, pte.T5Config(**tt.T5_SMALL, **f32), device="cpu")
        _same_state(got.module.state_dict(), cj.from_jax_text_params(_jnp_tree(want.params)))

    def test_wan_sniffs_but_does_not_load(self):
        assert pload.sniff_model_family(FAMILIES["wan-14b"]) == "wan-14b"
        with pytest.raises(NotImplementedError, match="item 10"):
            pload.load_wan_checkpoint({}, None)


class TestParamsRoundTrip:
    def test_save_and_load_params(self, tmp_path):
        from comfyui_parallelanything_tpu_torch.models import convert as pconv
        from comfyui_parallelanything_tpu_torch.models import flux as pflux

        from test_torch_convert import SMALL, _sd

        cfg = pflux.flux_dev_config(**SMALL)  # bf16 and f32 parameters
        state = pconv.convert_flux_checkpoint(_sd(), cfg)
        pckpt.save_params(tmp_path / "p.pt", state)
        back = pckpt.load_params(tmp_path / "p.pt")
        assert list(back) == list(state)
        for k in state:
            assert back[k].dtype == state[k].dtype and torch.equal(back[k], state[k])
        model = pflux.build_flux(cfg, device="cpu", state_dict=back, assign=True)
        pckpt.save_params(tmp_path / "m.pt", model.module)
        again = pckpt.load_params(tmp_path / "m.pt", device="cpu")
        assert all(torch.equal(again[k], state[k]) for k in state)
        with pytest.raises(TypeError):
            pckpt.save_params(tmp_path / "x.pt", [1, 2])
