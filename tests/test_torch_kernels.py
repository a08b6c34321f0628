"""The port's flash-attention kernel K1 (``ops/kernels/flash_attention.py``).

On the CPU the wrapper computes its plain version, which is held against the JAX
package's Pallas kernel in interpret mode on the cases of the JAX kernel's own
tests (rtol/atol 2e-4 in f32). The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_check_rejects_planted_tail_bugs(dtype):
    # The limits the card's smoke run holds K1 to accept the plain version's own
    # rounding to ``dtype`` and reject a kernel that leaves the padded keys of the
    # last 64-key block unmasked or drops the last key (300 queries, 513 keys).
    import chip_smoke

    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(11, 1, 300, 513, 2, 128))
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
    assert (build.CSRC_DIR / build.SOURCES["flash_attention"]).exists()
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
