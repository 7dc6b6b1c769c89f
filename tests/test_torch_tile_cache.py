"""The port's tile cache, its JSON file and its autotuner against the JAX
package's (``repro.core.ops.tiles``), on the CPU.

The file is one format for both packages (``"impl/m/n/k" -> [bm, bn,
bk]`` at ``REPRO_TILE_CACHE``), so a file either writes loads in the
other with equal entries.  Also held: the merge over the file on disk
(this process wins per shape), a corrupt file loading 0 with no
temporary left behind, ``autotune_tiles`` on the ``cuda`` impl's plain
route (the fp8 / int8 rungs' quantization grid), ``gemm(..., tiles=)``
and both launchers' ``--tile-cache``.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.core.ops import tiles as jtiles
from repro_torch.core import ops
from repro_torch.core.ops import tiles
from repro_torch.kernels import gemm_lowp as gl
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

ENTRIES = {("cuda", 4, 6912, 1152): (8, 256, 256), ("cuda", 700, 6912, 1152): (128, 128, 256),
           ("cuda_grouped", 2800, 10752, 6144): (64, 256, 256)}


@pytest.fixture(autouse=True)
def caches(monkeypatch):
    """Each test starts from empty caches in both packages and no
    REPRO_TILE_CACHE, and leaves them as it found them."""
    monkeypatch.delenv("REPRO_TILE_CACHE", raising=False)
    saved = dict(tiles._TILE_CACHE), dict(jtiles._TILE_CACHE)
    tiles.clear_tile_cache()
    jtiles.clear_tile_cache()
    yield
    for mod, entries in zip((tiles, jtiles), saved):
        mod.clear_tile_cache()
        mod._TILE_CACHE.update(entries)


def _fill(mod, entries):
    for (impl, m, n, k), t in entries.items():
        mod.set_tiles(impl, m, n, k, mod.TileConfig(*t))


def _entries(mod):
    return {key: (t.bm, t.bn, t.bk) for key, t in mod._TILE_CACHE.items()}


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_a_file_either_package_saves_loads_in_the_other(tmp_path, writer):
    path = str(tmp_path / "tiles.json")
    src, dst = (tiles, jtiles) if writer == "port" else (jtiles, tiles)
    _fill(src, ENTRIES)
    assert src.save_tile_cache(path) == path
    assert dst.load_tile_cache(path) == len(ENTRIES)
    assert _entries(dst) == ENTRIES
    assert all(isinstance(t, dst.TileConfig) for t in dst._TILE_CACHE.values())


def test_the_files_are_byte_equal(tmp_path):
    _fill(tiles, ENTRIES)
    _fill(jtiles, ENTRIES)
    tiles.save_tile_cache(str(tmp_path / "port.json"))
    jtiles.save_tile_cache(str(tmp_path / "repro.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "repro.json").read_bytes()


def test_save_merges_over_the_file_and_this_process_wins(tmp_path):
    path = tmp_path / "tiles.json"
    path.write_text(json.dumps({"cuda/4/6912/1152": [8, 128, 128],
                                "cuda/16/64/64": [16, 128, 128]}))
    _fill(tiles, ENTRIES)
    tiles.save_tile_cache(str(path))
    on_disk = json.loads(path.read_text())
    assert on_disk["cuda/16/64/64"] == [16, 128, 128]        # another shape kept
    assert on_disk["cuda/4/6912/1152"] == [8, 256, 256]      # this process's
    assert len(on_disk) == len(ENTRIES) + 1
    assert not (tmp_path / "tiles.json.tmp").exists()


@pytest.mark.parametrize("text", ["{not json", '{"cuda/4/8": [1, 2, 3]}', '["cuda/4/8/16"]',
                                  '{"cuda/4/8/16": [1, 2]}'])
def test_a_corrupt_file_loads_nothing_and_leaves_no_tmp(tmp_path, text):
    path = tmp_path / "tiles.json"
    path.write_text(text)
    assert tiles.load_tile_cache(str(path)) == 0
    assert tiles._TILE_CACHE == {}
    _fill(tiles, ENTRIES)
    tiles.save_tile_cache(str(path))               # rewritten whole
    assert {tuple(v) for v in json.loads(path.read_text()).values()} == set(ENTRIES.values())
    assert [p.name for p in tmp_path.iterdir()] == ["tiles.json"]


def test_no_path_saves_and_loads_nothing(tmp_path):
    _fill(tiles, ENTRIES)
    assert tiles.tile_cache_path() is None
    assert tiles.save_tile_cache() is None and tiles.load_tile_cache() == 0
    assert tiles.load_tile_cache(str(tmp_path / "absent.json")) == 0


def test_autotune_caches_and_persists_the_winner(tmp_path, monkeypatch):
    """On the CPU the ``cuda`` impl runs ``gemm_lowp``'s plain twin: the
    winner is one of repro's candidates, the tile the shape dispatches
    from then on, and in the file REPRO_TILE_CACHE names."""
    path = tmp_path / "tiles.json"
    monkeypatch.setenv("REPRO_TILE_CACHE", str(path))
    m, n, k = 8, 384, 320
    timings = {}
    best = tiles.autotune_tiles("cuda", m, n, k, policy="fp8x3", device="cpu", reps=1,
                                timings=timings)
    want = list(dict.fromkeys(jtiles.TileConfig(bm, bn, bk).clamp(m, n, k)
                              for bm in (128, 256) for bn in (128, 256) for bk in (128, 256)))
    assert [(t.bm, t.bn, t.bk) for t in timings] == [(t.bm, t.bn, t.bk) for t in want]
    assert all(t > 0 for t in timings.values())
    assert tiles.tile_for("cuda", m, n, k) == best
    assert json.loads(path.read_text()) == {f"cuda/{m}/{n}/{k}": [best.bm, best.bn, best.bk]}


def test_autotune_without_persist_writes_nothing(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"
    monkeypatch.setenv("REPRO_TILE_CACHE", str(path))
    best = tiles.autotune_tiles("cuda", 8, 256, 256, policy="int8x3", device="cpu", reps=1,
                                persist=False)
    assert tiles.tile_for("cuda", 8, 256, 256) == best
    assert not path.exists()


def test_gemm_tiles_keyword_sets_the_quantization_grid():
    """``gemm(..., tiles=)`` runs the fp8x3 rung on that grid (clamped),
    bit-equal to ``gemm_lowp`` there, and leaves the cache alone; a grid
    of bk = 128 in place of 256 moves the result."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(-1, 1, (8, 320)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (320, 384)).astype(np.float32))
    outs = {}
    for bk in (128, 256):
        t = ops.TileConfig(128, 128, bk)
        got = ops.gemm(a, b, policy="fp8x3", backend="cuda", tiles=t)
        c = t.clamp(8, 384, 320)
        want = gl.gemm_lowp(a, b, policy="fp8x3", bm=c.bm, bn=c.bn, bk=c.bk)
        assert torch.equal(got, want)
        outs[bk] = got
    assert not torch.equal(outs[128], outs[256])
    assert tiles._TILE_CACHE == {}
    assert tiles.tile_for("cuda", 8, 384, 320) == tiles.TileConfig().clamp(8, 384, 320)


def _cli(main, argv) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_tile_cache_flag_overrides_the_inherited_variable(tmp_path, monkeypatch, cli):
    inherited, flagged = tmp_path / "inherited.json", tmp_path / "flag.json"
    inherited.write_text(json.dumps({"cuda/1/2/3": [8, 128, 128]}))
    flagged.write_text(json.dumps({f"{i}/{m}/{n}/{k}": list(t)
                                   for (i, m, n, k), t in ENTRIES.items()}))
    monkeypatch.setenv("REPRO_TILE_CACHE", str(inherited))
    common = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--tile-cache", str(flagged)]
    if cli == "serve":
        text = _cli(tserve.main, common + ["--requests", "1", "--max-new", "2"])
    else:
        text = _cli(ttrain.main, common + ["--steps", "1", "--batch", "2", "--seq", "8"])
    assert f"tile cache: {len(ENTRIES)} shape(s) loaded from {flagged}" in text
    assert tiles.tile_cache_path() == str(flagged)
    assert _entries(tiles) == ENTRIES


def test_inherited_variable_loads_without_the_flag(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"
    path.write_text(json.dumps({"cuda/4/6912/1152": [8, 256, 256]}))
    monkeypatch.setenv("REPRO_TILE_CACHE", str(path))
    text = _cli(tserve.main, ["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                              "--requests", "1", "--max-new", "2"])
    assert f"tile cache: 1 shape(s) loaded from {path}" in text
