"""chip_smoke.py and the compile-cache placement.

Tests marked ``gpu`` run the checks of chip_smoke.py on a GPU and skip
elsewhere (decided in the ``gpu`` fixture); run them on the card with
``python -m pytest tests/test_chip.py -m gpu``."""

import os

import jax
import pytest

import chip_smoke
from tpufluid.utils import cache


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_follows_env(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env


def test_chip_smoke_device_phase_fails_without_gpu(capsys):
    with pytest.raises(chip_smoke.CheckFailed, match="no GPU"):
        chip_smoke.device_phase()
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_gpu_kernels_match_plain_at_1m(gpu):
    from tpufluid import models
    from tpufluid.ops import resident

    scene = models.scene_1m()
    gs = resident.make_grid_multi_step(scene.settings, 20)(
        resident.init_grid_state(scene.settings), scene.params)
    chip_smoke.compare_physics(gs, scene.settings, scene.params, "1M")


@pytest.mark.gpu
def test_gpu_step_holds_compiled_kernels(gpu):
    from tpufluid import models
    from tpufluid.ops import resident

    scene = models.scene_1m()
    chip_smoke.check_step_lowering(
        scene.settings, scene.params,
        resident.init_grid_state(scene.settings))
