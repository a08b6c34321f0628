"""``workflow_sd15_hiresfix`` end to end through both graph hosts (the port's on the
CPU, the JAX package's), on the same tiny random weights and injected noise:
a 2-step pass, a 2× latent upscale, a 2-step pass at denoise 0.55 on the upscaled
latent, the decode, and a tiny ESRGAN ×4 (the port's RRDBNet written in the
public layout by ``chip_smoke.write_upscaler_file``). The synthetic world and the
helpers are ``test_torch_graphs_sd15``'s."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import test_torch_graphs_sd15 as g  # noqa: E402

graph_env = g.graph_env


def test_hiresfix_matches_jax(graph_env, cpu_devices):
    from comfyui_parallelanything_tpu_torch.models import upscale as pup

    up = pup.build_upscaler(pup.UpscaleConfig(nf=8, nb=1, gc=4), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in up.module.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1)  # lifts the output off the clip at 0
    path = f"{graph_env['tmp']}/esrgan_tiny.safetensors"
    g.chip_smoke.write_upscaler_file(path, up)
    wf = g.load_example("workflow_sd15_hiresfix", graph_env)
    wf["esrgan"]["inputs"]["ckpt_path"] = path
    got, want = g.run_both(wf)
    lat = g.LATENT_HW // 8
    assert got["sampler"][0]["samples"].shape == (1, lat, lat, 4)
    assert got["latent_up"][0]["samples"].shape == (1, 2 * lat, 2 * lat, 4)
    for node in ("sampler", "latent_up", "hires_pass"):
        g.assert_close(got[node][0]["samples"], want[node][0]["samples"], node)
    g.assert_close(got["decode"][0], want["decode"][0], "decode")
    final = got["final_upscale"][0]
    assert final.shape == (1, 8 * 2 * lat, 8 * 2 * lat, 3)  # VAE ×2 on 2× latent, ESRGAN ×4
    assert 0.0 < float(final.mean()) < 1.0
    g.assert_close(final, want["final_upscale"][0], "final_upscale")
    g.assert_saved(got, 1)
