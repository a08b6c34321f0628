"""Parity of the PyTorch port's ``WanVideoPipeline`` image→video path against the
JAX package on the CPU, on the tiny Wan world of ``tests/test_torch_wan_pipeline.py``
(whose helpers build it): the start image as frame 0 encoded whole with the frame
mask, and the CLIP branch, with the same noise on both sides. f32 on both sides,
rtol/atol 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import pipelines as jpipe  # noqa: E402
from comfyui_parallelanything_tpu_torch import pipelines as ppipe  # noqa: E402

from test_torch_wan_pipeline import (  # noqa: E402,F401
    CALL,
    CFG,
    I2V,
    _hermetic,
    _same,
    _text_encoders,
    _vae_pair,
    _video,
    _wan_pair,
    same_noise,
)


@pytest.fixture(scope="module")
def world():
    jv, pv, _ = _vae_pair()
    jtext, ptext = _text_encoders()
    ji2v, pi2v, _ = _wan_pair(4, **I2V)
    return {"i2v": (jpipe.WanVideoPipeline(dit=ji2v, vae=jv, **jtext),
                    ppipe.WanVideoPipeline(dit=pi2v, vae=pv, **ptext))}


def test_i2v_with_clip_vision_matches_jax(world, same_noise):
    jp, pp = world["i2v"]
    image = _video(2, (1, 16, 16, 3))
    fea = np.random.default_rng(3).normal(size=(1, 5, 24)).astype(np.float32)
    kw = dict(CALL, **CFG)
    _same(pp("hello", image=image, clip_vision_output={"penultimate": fea}, **kw),
          jp("hello", image=jnp.asarray(image),
             clip_vision_output={"penultimate": jnp.asarray(fea)}, **kw))
