"""The port's Threefry random numbers against the JAX package's, bit for
bit (raytracingrust_tpu_torch/utils/rng.py vs raytracingrust_tpu/utils/rng.py).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import jax.numpy as jnp
import numpy as np

from raytracingrust_tpu.utils import rng as jrng
from raytracingrust_tpu_torch.utils import rng as trng

SEED_HIGH = 0xDEADBEEFCAFEBABE  # both key words >= 2^31


def _u32(n, rs):
    # random words plus the wrap-around edge
    x = rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2 ** 32 - 1, 2 ** 32 - 2]
    return x


def _t(x):
    return torch.as_tensor(x.astype(np.int64))


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry2x32_bitwise(rounds):
    rs = np.random.RandomState(rounds)
    k0, k1, x0, x1 = (_u32(256, rs) for _ in range(4))
    want = jrng.threefry2x32(jnp.asarray(k0), jnp.asarray(k1),
                             jnp.asarray(x0), jnp.asarray(x1), rounds=rounds)
    got = trng.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1), rounds=rounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


def test_bits_to_uniform_bitwise():
    bits = _u32(4096, np.random.RandomState(1))
    want = np.asarray(jrng.bits_to_uniform(jnp.asarray(bits)))
    got = trng.bits_to_uniform(_t(bits)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("seed", [0, 1234, SEED_HIGH])
def test_base_key_words(seed):
    assert trng.base_key(seed) == tuple(
        int(w) for w in np.asarray(jrng.base_key(seed)))


@pytest.mark.parametrize("stream", [0, 1, 7])
@pytest.mark.parametrize("seed", [0, SEED_HIGH])
def test_ray_uniforms_bitwise(stream, seed):
    ids = np.concatenate([np.arange(500), 2 ** 31 - 1 - np.arange(12)]
                         ).astype(np.int32)
    want = np.asarray(jrng.ray_uniforms(jrng.base_key(seed), jnp.asarray(ids),
                                        stream, 5))
    got = trng.ray_uniforms(trng.base_key(seed), torch.as_tensor(ids),
                            stream, 5).numpy()
    assert got.shape == (len(ids), 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_ray_uniforms_cipher_block_bound():
    with pytest.raises(ValueError):
        trng.ray_uniforms((0, 0), torch.arange(4), 0,
                          2 * trng.CIPHER_BLOCK + 1)
