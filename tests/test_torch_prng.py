"""PyTorch port: the threefry-2x32 twin against ``jax.random``.

jax 0.9 defaults: ``jax_threefry_partitionable=True``, 64-bit mode off,
raw ``uint32[2]`` keys.  Every result is integer bits, compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving.page_pool import kv_noise


def _np(key):
    return np.asarray(key).astype(np.int64)


def test_jax_defaults_are_the_twins_variant():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 1, 17, 12345, 2**31 - 1, -1, -2**31])
def test_prng_key(seed):
    np.testing.assert_array_equal(_np(jax.random.PRNGKey(seed)),
                                  prng.prng_key(seed).numpy())


@pytest.mark.parametrize("num", [1, 2, 3, 24, 1000])
def test_split(num):
    k = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(_np(jax.random.split(k, num)),
                                  prng.split(prng.prng_key(42), num).numpy())


def test_split_and_fold_in_batched():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    tk = torch.from_numpy(_np(keys))
    ref = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    np.testing.assert_array_equal(_np(ref), prng.split(tk, 4).numpy())
    data = np.asarray([0, 1, 7, 2**31 - 1, 2**32 - 1], np.uint32)
    ref = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data))
    port = prng.fold_in(tk, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(_np(ref), port.numpy())


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2**31 - 1])
def test_fold_in(data):
    k = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(
        _np(jax.random.fold_in(k, data)),
        prng.fold_in(prng.prng_key(9), data).numpy())


def test_random_bits():
    k = jax.random.PRNGKey(11)
    ref = jax.random.bits(k, (3, 5), dtype=jnp.uint32)
    np.testing.assert_array_equal(
        _np(ref), prng.random_bits(prng.prng_key(11), (3, 5)).numpy())


@pytest.mark.parametrize("shift", [20, 21])
def test_randint_uint32_stochastic_noise(shift):
    """The KV-write noise: uint32 in [0, 1 << (23 - man_bits))."""
    k = jax.random.PRNGKey(5)
    ref = jax.random.randint(k, (2, 16), 0, 1 << shift, dtype=jnp.uint32)
    port = prng.randint(prng.prng_key(5), (2, 16), 0, 1 << shift,
                        torch.uint32)
    np.testing.assert_array_equal(_np(ref), port.numpy())


def test_randint_int32_bits():
    """The reference's _rbits: int32 in [0, 2)."""
    k = jax.random.PRNGKey(6)
    ref = jax.random.randint(k, (4, 8, 8), 0, 2, dtype=jnp.int32)
    port = prng.randint(prng.prng_key(6), (4, 8, 8), 0, 2, torch.int32)
    np.testing.assert_array_equal(_np(ref), port.numpy())


@pytest.mark.parametrize("lo,hi", [(3, 1000), (-7, 7), (0, 3), (5, 5)])
def test_randint_general_spans(lo, hi):
    """Non-power-of-two spans use the reference's two-draw combine."""
    k = jax.random.PRNGKey(8)
    ref = jax.random.randint(k, (64,), lo, hi, dtype=jnp.int32)
    port = prng.randint(prng.prng_key(8), (64,), lo, hi, torch.int32)
    np.testing.assert_array_equal(_np(ref), port.numpy())


def test_randint_rejects_out_of_range_bounds():
    with pytest.raises(ValueError):
        prng.randint(prng.prng_key(0), (2,), 0, 2**32, torch.int32)


def test_model_noise_equals_the_reference_stream_chain():
    """Model.kv_noise reproduces the reference's key chain for every
    layer, K and V, and slot: serve.py stream fold -> model.py fold 0 ->
    transformer.py split over blocks + fold of the pattern index ->
    attention.py split + fold of the write position -> quant.py randint,
    drawn per slot over (KV, hd) as page_pool.encode_kv's vmap does."""
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    model = Model(cfg)
    stream = jax.random.fold_in(jax.random.PRNGKey(0 + 17), 0)
    pos = np.asarray([[0, 5, 16, 31], [1, 6, 17, 2]], np.int32)  # [T, B]
    port = model.kv_noise(torch.from_numpy(_np(stream)),
                          torch.from_numpy(pos))
    assert port.shape == (2, cfg.n_layers, 2, 4, cfg.n_kv_heads, cfg.hd)
    shift = 21  # e5m2
    bkey = jax.random.fold_in(stream, 0)
    blocks = jax.random.split(bkey, cfg.n_layers)
    for layer in range(cfg.n_layers):
        kk, vk = jax.random.split(jax.random.fold_in(blocks[layer], 0))
        for kv, key in enumerate((kk, vk)):
            for t in range(pos.shape[0]):
                keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                    key, jnp.asarray(pos[t]))
                ref = jax.vmap(lambda kb: jax.random.randint(
                    kb, (cfg.n_kv_heads, cfg.hd), 0, 1 << shift,
                    dtype=jnp.uint32))(keys)
                np.testing.assert_array_equal(
                    _np(ref), port[t, layer, kv].numpy(),
                    err_msg=f"layer {layer} {'kv'[kv]} t {t}")


def test_kv_noise_range():
    keys = prng.split(prng.prng_key(1), 6)
    n = kv_noise(keys, (2, 16), "e4m3")
    assert n.shape == (6, 2, 16)
    assert int(n.min()) >= 0 and int(n.max()) < 1 << 20
