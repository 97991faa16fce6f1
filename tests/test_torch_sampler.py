"""The port's sampler against ``jax.random`` and the reference's
``sample_tokens_rowwise`` on the CPU, on keys and logits drawn with
numpy.

Key chains, bits and uniforms must be equal bit for bit.  The Gumbel
noise ``-log(-log(u))`` goes through the platform's ``log``, not XLA's,
so it is held within ``GUMBEL_ULPS`` float32 ulps at the noise's scale
floored at 1 (the inner ``-log(u)`` is O(1), so its rounding sets the
absolute error when the noise is near 0).  Sampled tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import sample_tokens_rowwise as jax_rowwise

from repro_torch.serving import sampler

RNG = np.random.default_rng(11)
SEEDS = [0, 7, 2**32 - 1] + [int(s) for s in RNG.integers(0, 2**32, 4)]
GUMBEL_ULPS = 4
TINY = np.finfo(np.float32).tiny


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(sampler.key(seed), _data(k))
    for n in (2, 8):
        np.testing.assert_array_equal(sampler.split(sampler.key(seed), n),
                                      _data(jax.random.split(k, n)))
    for d in (0, 1, 3, int(RNG.integers(0, 2**32))):
        np.testing.assert_array_equal(
            sampler.fold_in(sampler.key(seed), d),
            _data(jax.random.fold_in(k, d)))
    # one chain step of many rows at once, as the decode stream takes it
    rows = jax.random.split(k, 5)
    nxt, sub = sampler.split_rows(_data(rows))
    pair = _data(jax.vmap(lambda r: jax.random.split(r, 2))(rows))
    np.testing.assert_array_equal(nxt, pair[:, 0])
    np.testing.assert_array_equal(sub, pair[:, 1])


def test_known_answers():
    """Values of jax 0.9.0 with ``jax_threefry_partitionable`` on."""
    np.testing.assert_array_equal(sampler.key(0), [0, 0])
    np.testing.assert_array_equal(
        sampler.split(sampler.key(0), 2),
        [[1797259609, 2579123966], [928981903, 3453687069]])
    np.testing.assert_array_equal(sampler.fold_in(sampler.key(0), 3),
                                  [2467461003, 3840466878])
    np.testing.assert_array_equal(
        sampler.random_bits(sampler.key(0)[None], 4, "cpu")[0].numpy(),
        [4070199207, 4202968722, 1427181096, 2012915765])
    zeros = torch.zeros(1, 128256)
    for seed, want in ((0, 73608), (7, 96183)):
        got = sampler.sample_tokens_rowwise(sampler.key(seed)[None], zeros)
        assert got.tolist() == [want]


def test_bad_keys_raise():
    with pytest.raises(ValueError, match="seed"):
        sampler.key(-1)
    with pytest.raises(ValueError, match="seed"):
        sampler.key(2**32)
    with pytest.raises(ValueError, match="trailing axis"):
        sampler.split(np.zeros(3, np.uint32), 2)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        sampler.split_rows([[0, 2**32]])
    with pytest.raises(ValueError, match="keys for"):
        sampler.sample_tokens_rowwise(sampler.split(sampler.key(0), 2),
                                      torch.zeros(3, 5))


def _check_bits_uniform_gumbel(seed, n):
    k = jax.random.key(seed)
    keys = sampler.key(seed)[None]
    bits = sampler.random_bits(keys, n, "cpu")[0].numpy()
    np.testing.assert_array_equal(bits.astype(np.uint32),
                                  np.asarray(jax.random.bits(k, (n,))))
    u = sampler.uniform(keys, n, "cpu")[0].numpy()
    uj = np.asarray(jax.random.uniform(k, (n,), minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(u.view(np.uint32), uj.view(np.uint32))
    g = sampler.gumbel(keys, n, "cpu")[0].numpy()
    gj = np.asarray(jax.random.gumbel(k, (n,)))
    ulp = np.spacing(np.maximum(np.abs(gj), np.float32(1)))
    assert np.all(np.abs(g - gj) <= GUMBEL_ULPS * ulp)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_exact_gumbel_within_ulps(seed):
    _check_bits_uniform_gumbel(seed, 4099)


@pytest.mark.parametrize("seed", SEEDS)
def test_full_vocab_bits_uniform_exact_gumbel_within_ulps(seed):
    """At the Llama 3 vocab (128256), where the CPU's multi-threaded
    kernels cut the draw into one share per thread."""
    _check_bits_uniform_gumbel(seed, 128256)


@pytest.mark.parametrize("temperature", [1.0, 0.7, 0.0])
def test_sample_tokens_rowwise_matches_reference(temperature):
    B, V = 48, 37
    logits = (3 * RNG.normal(size=(B, V))).astype(np.float32)
    jkeys = jax.random.split(jax.random.key(5), B)
    want = np.asarray(jax_rowwise(jkeys, jnp.asarray(logits), temperature))
    got = sampler.sample_tokens_rowwise(_data(jkeys), torch.as_tensor(logits),
                                        temperature)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if temperature > 0:       # the noise did move some row off its argmax
        assert np.any(got != logits.argmax(-1))
