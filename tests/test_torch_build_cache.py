"""The port's build directory (``mmtraj_torch/utils/build_cache.py``): the
stats, LRU trim and clear cases of ``tests/test_compile_cache.py`` against
the port's variables, the trim before a first build that spares the current
libraries, the "off" values, and ``cli cache`` beside the JAX package's."""

import os
import time

import pytest

from mmtraj_torch.cli import main as cli_main
from mmtraj_torch.native import build as native_build
from mmtraj_torch.ops import _build
from mmtraj_torch.utils import build_cache
from mmtraj_torch.utils.build_cache import (cache_stats, clear_cache, resolve_cache_dir,
                                            trim_cache)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh build directory of 5 entries of 1000 bytes, entry i older than
    entry i + 1, that this process has not trimmed yet."""
    d = tmp_path / "build"
    d.mkdir()
    monkeypatch.setenv(build_cache.ENV_DIR, str(d))
    monkeypatch.delenv(build_cache.ENV_MAX_GB, raising=False)
    monkeypatch.setattr(build_cache, "_trimmed", set())
    now = time.time()
    for i in range(5):
        p = d / f"entry{i}"
        p.write_bytes(b"x" * 1000)
        os.utime(p, (now - 100 + i, now - 100 + i))
    return d


def _current(d):
    """The current libraries, written as fakes (so nothing compiles), newest
    written first so that they are the oldest entries."""
    libs = [_build.library_path(n) for n in _build.KERNELS] + [native_build.library_path()]
    for i, p in enumerate(libs):
        assert p.parent == d
        p.write_bytes(b"so" * 1000)
        os.utime(p, (i, i))
    return libs


def test_resolve_precedence(tmp_path, monkeypatch):
    monkeypatch.delenv(build_cache.ENV_DIR, raising=False)
    assert resolve_cache_dir(str(tmp_path)) == str(tmp_path)
    assert resolve_cache_dir(None) == str(build_cache.DEFAULT_DIR)
    assert build_cache.DEFAULT_DIR.parent.name == "mmtraj_torch"
    monkeypatch.setenv(build_cache.ENV_DIR, "")
    assert resolve_cache_dir(None) == str(build_cache.DEFAULT_DIR)
    monkeypatch.setenv(build_cache.ENV_DIR, str(tmp_path / "env"))
    assert resolve_cache_dir(None) == str(tmp_path / "env")
    assert resolve_cache_dir(str(tmp_path)) == str(tmp_path)  # an explicit arg beats the env
    # Both builds resolve their directory here.
    assert _build.library_path("gat").parent == tmp_path / "env"
    assert native_build.library_path().parent == tmp_path / "env"


@pytest.mark.parametrize("off", ["0", "off", "NONE", "False"])
def test_off_values_raise_naming_the_variable(off, monkeypatch, capsys):
    monkeypatch.setenv(build_cache.ENV_DIR, off)
    for fn in (resolve_cache_dir, cache_stats, build_cache.build_dir):
        with pytest.raises(ValueError, match="MMTRAJ_TORCH_BUILD_CACHE"):
            fn()
    with pytest.raises(SystemExit) as e:
        cli_main(["cache"])
    assert e.value.code == 2 and "MMTRAJ_TORCH_BUILD_CACHE" in capsys.readouterr().err


def test_stats_trim_clear_lru(cache, monkeypatch):
    """Stats count every entry; trim removes the oldest first until under the
    cap; the first build in a process trims by the env policy; a cap of 0
    never trims; clear empties."""
    s = cache_stats()
    assert (s["dir"], s["entries"], s["total_bytes"]) == (str(cache), 5, 5000)
    assert trim_cache(max_bytes=2500) == (3, 3000)
    assert sorted(p.name for p in cache.iterdir()) == ["entry3", "entry4"]

    # The first build trims by the policy (1 kB here), sparing what it loads.
    libs = _current(cache)
    monkeypatch.setenv(build_cache.ENV_MAX_GB, "0.000001")
    assert _build.build() == dict.fromkeys(_build.KERNELS, 0.0)  # all found built
    assert sorted(cache.iterdir()) == sorted(libs)
    assert native_build.build() == str(libs[-1])

    # MAX_GB = 0 never trims.
    (cache / "big").write_bytes(b"y" * 10000)
    monkeypatch.setenv(build_cache.ENV_MAX_GB, "0")
    monkeypatch.setattr(build_cache, "_trimmed", set())
    build_cache.build_dir()
    assert (cache / "big").exists()

    (cache / "gat.log").write_text("")  # an empty log counts and goes too
    assert clear_cache() == (len(libs) + 2, 10000 + 2000 * len(libs))
    assert cache_stats()["entries"] == 0 and list(cache.iterdir()) == []


def test_trim_spares_the_current_libraries_and_builds_in_progress(cache):
    libs = _current(cache)  # the oldest entries of all
    (cache / "libgat-0123456789abcdef.so").write_bytes(b"old" * 1000)  # an earlier tree's
    (cache / "libgat-feed.4242.tmp").write_bytes(b"t" * 1000)  # another process's build
    n, b = trim_cache(max_bytes=0)
    assert (n, b) == (6, 8000)
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [p.name for p in libs] + ["libgat-feed.4242.tmp"])


def test_native_build_trims_before_building(cache, monkeypatch, tmp_path):
    monkeypatch.setenv(build_cache.ENV_MAX_GB, "0.0000005")  # 500 bytes
    path = native_build.build()
    assert [p.name for p in cache.iterdir()] == [os.path.basename(path)]
    before = os.stat(path).st_mtime_ns
    assert native_build.build() == path and os.stat(path).st_mtime_ns == before  # found built


def test_cli_cache_prints_as_jax(cache, tmp_path, monkeypatch, capsys, request):
    import jax

    from mmtraj.cli import main as j_cli_main

    # JAX's CLI points this process's compile cache at its directory: put it back.
    request.addfinalizer(lambda d=jax.config.jax_compilation_cache_dir:
                         jax.config.update("jax_compilation_cache_dir", d))

    def both(*flags):
        assert cli_main(["cache", *flags]) == 0
        mine = capsys.readouterr().out
        assert j_cli_main(["cache", *flags]) == 0
        return mine, capsys.readouterr().out

    twin = tmp_path / "xla"
    twin.mkdir()
    for p in cache.iterdir():
        (twin / p.name).write_bytes(p.read_bytes())
        os.utime(twin / p.name, (p.stat().st_mtime, p.stat().st_mtime))
    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", str(twin))
    mine, theirs = both()
    assert mine == f"cache dir: {cache}\nentries: 5\nsize: 0.0 MB\n"
    assert mine.replace(str(cache), str(twin)) == theirs
    mine, theirs = both("--trim-gb", "0.0000025")
    assert mine.startswith("trimmed 3 entries (0.0 MB)\n") and "entries: 2" in mine
    assert mine.replace(str(cache), str(twin)) == theirs
    mine, theirs = both("--clear")
    assert mine.startswith("cleared 2 entries") and "entries: 0" in mine
    assert mine.replace(str(cache), str(twin)) == theirs
