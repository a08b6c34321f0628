"""``workflow_sd15_img2img`` end to end through both graph hosts (the port's on the
CPU, the JAX package's), on the same tiny random weights and injected noise: a
PNG through ``TPULoadImage``, a seeded ``TPUVAEEncode`` (its posterior draw
injected on both sides), a 2-step pass at denoise 0.6 and the decode. The
synthetic world and the helpers are ``test_torch_graphs_sd15``'s."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import test_torch_graphs_sd15 as g  # noqa: E402

graph_env = g.graph_env


def test_img2img_matches_jax(graph_env, cpu_devices):
    from PIL import Image

    src = f"{graph_env['tmp']}/input.png"
    Image.fromarray((np.random.default_rng(0).uniform(0, 1, (16, 16, 3)) * 255)
                    .astype(np.uint8)).save(src)
    wf = g.load_example("workflow_sd15_img2img", graph_env)
    wf["source"]["inputs"]["image_path"] = src
    got, want = g.run_both(wf)
    g.assert_close(got["source"][0], want["source"][0], "image", dict(rtol=0, atol=0))
    g.assert_close(got["encode"][0]["samples"], want["encode"][0]["samples"], "encode",
                   dict(rtol=2e-4, atol=2e-4))
    assert got["sampler"][0]["samples"].shape == (1, 8, 8, 4)  # 16 px over the VAE's ×2
    g.assert_close(got["sampler"][0]["samples"], want["sampler"][0]["samples"], "latent")
    g.assert_close(got["decode"][0], want["decode"][0], "decode")
    g.assert_saved(got, 1)
