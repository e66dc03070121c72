"""PyTorch port: the autotuner's cache and ``flash_blocks``, mirroring
``tests/test_autotune.py`` for what the port has.

``test_pre_device_kind_cache_entries_stay_readable`` has no counterpart:
the port never wrote keys without a device name, so it reads no legacy
key format.  The matmul, elementwise and paged tilings are not ported
(no port kernel takes a tiling yet); ``choose_matmul_impl`` is held in
``tests/test_torch_quant_matmul.py``.
"""
import json

import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.kernels import autotune, cuda_build
from repro_torch.kernels import flash_attention as fa
from repro_torch.serving.telemetry import default_registry


@pytest.fixture()
def tuner_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear_memory_cache()
    jautotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()
    jautotune.clear_memory_cache()


def _gauge(site, config, source):
    return default_registry().gauge_value(
        "autotune_block_us", kernel="flash", site=site, config=config,
        source=source)


def test_cache_path_default_and_override(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert autotune.cache_path() == \
        tmp_path / ".cache" / "repro_torch" / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert autotune.cache_path() == tmp_path / "x.json"


@pytest.mark.parametrize("env,cpu,cuda", [
    (None, False, True), ("0", False, False), ("off", False, False),
    ("never", False, False), ("1", True, True), ("force", True, True),
    ("always", True, True)])
def test_measurement_switch(monkeypatch, env, cpu, cuda):
    if env is None:
        monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("REPRO_AUTOTUNE", env)
    assert autotune._should_measure("cpu") is cpu
    assert autotune._should_measure(torch.device("cuda", 0)) is cuda


def test_heuristic_without_measurement(tuner_cache):
    """On the CPU with REPRO_AUTOTUNE unset nothing is measured: the
    reference's default, published as such, and nothing persisted."""
    assert autotune.flash_blocks(256, 256, 64, 64, device="cpu") == (128, 128)
    assert autotune.flash_blocks(40, 37, 64, 64, device="cpu") == (40, 128)
    assert _gauge("256x256x64x64", "128x128", "heuristic") == -1.0
    assert not tuner_cache.exists()


def test_cache_roundtrip_and_persistence(tuner_cache):
    key = "flash|torch-cpu|cpu|f32|64x64x32x32"
    autotune._store(key, (32, 64))
    autotune.clear_memory_cache()   # a fresh view must re-read the file
    assert tuner_cache.exists()
    assert autotune.flash_blocks(64, 64, 32, 32, device="cpu") == (32, 64)
    assert json.loads(tuner_cache.read_text())[key] == [32, 64]
    assert _gauge("64x64x32x32", "32x64", "cached") == -1.0


def test_forced_measurement_populates_cache(tuner_cache, monkeypatch):
    """REPRO_AUTOTUNE=force on the CPU times the plain version over the
    candidates (no launch), caches the fastest under a key with the
    port's backend tag and the device name, and replays it."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    before = fa.flash_attention.launches
    blocks = autotune.flash_blocks(128, 128, 16, 16, device="cpu")
    assert blocks in [(64, 64), (64, 128), (128, 64), (128, 128)]
    assert fa.flash_attention.launches == before
    (key,) = json.loads(tuner_cache.read_text())
    assert key == f"flash|torch-cpu|{autotune._device_kind('cpu')}|f32|" \
        "128x128x16x16"
    assert key.startswith("flash|torch-cpu|cpu|")
    assert _gauge("128x128x16x16", "x".join(map(str, blocks)),
                  "measured") > 0
    autotune.clear_memory_cache()
    assert autotune.flash_blocks(128, 128, 16, 16, device="cpu") == blocks
    # below the smallest candidate the default alone is measured and cached
    assert autotune.flash_blocks(16, 16, 16, 16, device="cpu") == (16, 16)
    assert len(json.loads(tuner_cache.read_text())) == 2


def test_unpinned_wrapper_call_asks_the_tuner(tuner_cache, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    q = torch.randn(1, 64, 2, 16)
    k = v = torch.randn(1, 64, 1, 16)
    out = fa.flash_attention(q, k, v)
    (key, blocks), = json.loads(tuner_cache.read_text()).items()
    assert key == "flash|torch-cpu|cpu|f32|64x64x16x16" and blocks == [64, 64]
    torch.testing.assert_close(out, fa.flash_attention(q, k, v, bq=64, bk=64),
                               rtol=0, atol=0)


def test_forced_measurement_runs_in_the_callers_dtype(tuner_cache,
                                                     monkeypatch):
    """A bf16 call measures its candidates on bf16 operands (K6 runs
    another body for bf16 than for float32) and caches under a key that
    names bf16; a float32 call at the same shape measures again in
    float32 and keys apart."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    real = fa.flash_attention
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    q = torch.randn(1, 64, 2, 16).to(torch.bfloat16)
    k = v = torch.randn(1, 64, 1, 16).to(torch.bfloat16)
    real(q, k, v)
    assert seen and set(seen) == {(torch.bfloat16,) * 3}
    assert list(json.loads(tuner_cache.read_text())) == [
        "flash|torch-cpu|cpu|bf16|64x64x16x16"]
    seen.clear()
    real(q.float(), k.float(), v.float())
    assert seen and set(seen) == {(torch.float32,) * 3}
    assert sorted(json.loads(tuner_cache.read_text())) == [
        "flash|torch-cpu|cpu|bf16|64x64x16x16",
        "flash|torch-cpu|cpu|f32|64x64x16x16"]


def test_device_names_key_apart(tuner_cache, monkeypatch):
    """A tiling cached for one card is not replayed on another."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    autotune._store("flash|torch-cuda|NVIDIA_A100|f32|64x64x32x32", (64, 64))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    dev = torch.device("cuda", 0)
    assert autotune._device_kind(dev) == "NVIDIA_H100_80GB_HBM3"
    assert autotune.flash_blocks(64, 64, 32, 32, device=dev) == (64, 64)
    assert _gauge("64x64x32x32", "64x64", "heuristic") == -1.0
    autotune._store("flash|torch-cuda|NVIDIA_H100_80GB_HBM3|f32|64x64x32x32",
                    (32, 32))
    assert autotune.flash_blocks(64, 64, 32, 32, device=dev) == (32, 32)


def test_jax_and_port_entries_never_replay_each_other(tuner_cache,
                                                      monkeypatch):
    """One cache file shared by both packages: each reads only its own
    backend tag."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    jkey = f"flash|cpu|{jautotune._device_kind()}|i1|64x64x32x32"
    jautotune._store(jkey, (8, 8))
    autotune.clear_memory_cache()
    assert autotune.flash_blocks(64, 64, 32, 32, device="cpu") == (64, 64)
    autotune._store("flash|torch-cpu|cpu|f32|48x48x32x32", (16, 16))
    jautotune.clear_memory_cache()
    assert jautotune.flash_blocks(48, 48, 32, 32, interpret=True) == (48, 48)
    assert jautotune.flash_blocks(64, 64, 32, 32, interpret=True) == (8, 8)


def test_candidate_failures_propagate(tuner_cache):
    def launch_fails(cand):
        def run():
            if cand == (2,):
                cuda_build.check_launch(700, "K6")
        return run

    with pytest.raises(cuda_build.KernelLaunchError, match="K6"):
        autotune._measure_best("k|c", [(1,), (2,)], launch_fails, "cpu",
                               kernel="flash", site="c")

    def refused(cand):
        raise ValueError("K6 takes bq in 8-256")

    with pytest.raises(ValueError, match="8-256"):
        autotune._measure_best("k|b", [(1,)], refused, "cpu",
                               kernel="flash", site="b")

    def crashes(cand):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        autotune._measure_best("k|d", [(1,)], crashes, "cpu",
                               kernel="flash", site="d")
    assert not tuner_cache.exists()


def test_time_call_counts_calls():
    calls = []
    assert autotune._time_call(lambda: calls.append(1), "cpu", n=3,
                               warmup=2) >= 0
    assert len(calls) == 5
