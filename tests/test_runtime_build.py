"""Build and cache rules: the persistent compile cache's location and the
native index library's content-keyed build."""
import os
import shutil
import subprocess
import sys

import jax

from gpismap.runtime import compile_cache, index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_dir_wins(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no path is set in code and the
    compiled program lands in that directory."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from gpismap.runtime.compile_cache import enable_compile_cache\n"
        "p = enable_compile_cache()\n"
        "assert p == jax.config.jax_compilation_cache_dir, p\n"
        "print(p)\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert any(tmp_path.iterdir()), "nothing cached in the env directory"


def test_index_library_is_keyed_on_its_sources(tmp_path, monkeypatch):
    """A change to gpis_index.cpp or the Makefile names a new library,
    so a build from other sources (or another host's flags) never
    loads; the Makefile builds for any x86-64 host."""
    with open(os.path.join(index._CSRC, "Makefile")) as f:
        assert "-march=native" not in f.read()
    for name in ("gpis_index.cpp", "Makefile"):
        shutil.copy(os.path.join(index._CSRC, name), tmp_path / name)
    monkeypatch.setattr(index, "_CSRC", str(tmp_path))
    a = index.lib_path()
    assert a == index.lib_path()
    assert os.path.dirname(a) == str(tmp_path)
    with open(tmp_path / "Makefile", "a") as f:
        f.write("\n# edit\n")
    b = index.lib_path()
    with open(tmp_path / "gpis_index.cpp", "a") as f:
        f.write("\n// edit\n")
    c = index.lib_path()
    assert len({a, b, c}) == 3
