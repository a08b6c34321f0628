"""``workflow_sd15_controlnet`` end to end through both graph hosts (the port's on
the CPU, the JAX package's), on the same tiny random weights and injected noise:
a tiny ControlNet of the tiny UNet's config (random zero convolutions, written in
the ldm layout through ``chip_smoke.ldm_unet_layout`` with the ControlNet
converter) applied at strength 0.8 to a PNG hint, 2 steps, the decode. The
synthetic world and the helpers are ``test_torch_graphs_sd15``'s."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import test_torch_graphs_sd15 as g  # noqa: E402

graph_env = g.graph_env


def test_controlnet_matches_jax(graph_env, cpu_devices):
    from PIL import Image

    from comfyui_parallelanything_tpu_torch.models import controlnet as pcn
    from comfyui_parallelanything_tpu_torch.models.convert_unet import (
        convert_controlnet_checkpoint,
    )
    from comfyui_parallelanything_tpu_torch.models.loader import save_safetensors

    cfg = g.pmodels.sd15_config()
    gen = torch.Generator().manual_seed(5)
    cn = pcn.build_controlnet(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for conv in cn.module.zero_convs():
            conv.weight.normal_(0.0, 0.1, generator=gen)
    state = cn.module.state_dict()
    sd = g.chip_smoke.ldm_unet_layout(cfg, state, convert=convert_controlnet_checkpoint)
    g.chip_smoke.check_round_trip(sd, lambda d: convert_controlnet_checkpoint(d, cfg), state,
                                  "controlnet")
    cn_path = f"{graph_env['tmp']}/cn.safetensors"
    save_safetensors(cn_path, sd)
    hint = f"{graph_env['tmp']}/hint.png"
    Image.fromarray((np.random.default_rng(3).uniform(0, 1, (32, 32, 3)) * 255)
                    .astype(np.uint8)).save(hint)
    wf = g.load_example("workflow_sd15_controlnet", graph_env)
    wf["hint"]["inputs"]["image_path"] = hint
    wf["controlnet"]["inputs"]["ckpt_path"] = cn_path
    got, want = g.run_both(wf)
    assert len(got["control"][0]["control"]) == 1
    g.assert_close(got["sampler"][0]["samples"], want["sampler"][0]["samples"], "latent")
    g.assert_close(got["decode"][0], want["decode"][0], "decode")
    # The ControlNet moves the latent: the same graph without it differs.
    plain = dict(wf)
    plain["sampler"] = {**wf["sampler"], "inputs": {**wf["sampler"]["inputs"],
                                                    "positive": ["positive", 0]}}
    base = g.phost.run_workflow(plain, device="cpu")
    assert not torch.allclose(base["sampler"][0]["samples"], got["sampler"][0]["samples"])
    g.assert_saved(got, 2)
