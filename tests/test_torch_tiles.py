"""The host-side choices of the port's CUDA wrappers, on the CPU: kernel A's
block form (``serve_fused.serve_tile``), kernel D's row stripes
(``update_fused.bwd_stripes``), kernel E's rows and column slice a warp
(``sage_agg.agg_form``), kernel I's rows a warp
(``sample_draw.draw_group``), and the build digest that decides when a
kernel library is rebuilt.  None of these needs a card; the kernels they
configure are held to their plain versions in ``test_torch_cuda.py``."""
import pytest

from repro_torch.kernels import (_build, sage_agg, sample_draw, serve_fused,
                                 update_fused)

H100_SMS = 132

# kernel A at the serving paths' shapes (M, K, D) on an H100: the form picked
SERVE_SHAPES = {
    "serve l0": ((11264, 256, 128), (64, 4)),
    "serve l1": ((1024, 256, 256), (16, 1)),
    "serve l2": ((64, 172, 256), (16, 1)),
    "offline l0": ((2048, 256, 128), (32, 1)),
    "offline l1": ((2048, 256, 256), (32, 1)),
    "offline l2": ((2048, 172, 256), (32, 1)),
    "sharded l0": ((22528, 256, 128), (64, 4)),
    "sharded l1": ((2048, 256, 256), (32, 1)),
    "sharded l2": ((128, 172, 256), (16, 1)),
}


def blocks(M, K, form):
    bm, tiles = form
    col_tiles = -(-K // serve_fused.BN)
    return -(-M // bm) * -(-col_tiles // tiles)


@pytest.mark.parametrize("path", sorted(SERVE_SHAPES))
def test_serve_tile_at_the_path_shapes(path):
    (M, K, D), want = SERVE_SHAPES[path]
    form = serve_fused.serve_tile(M, K, D, H100_SMS)
    assert form == want
    bm, tiles = form
    assert serve_fused.smem_bytes(bm, D) <= serve_fused.SMEM_LIMIT
    # the grid covers the card wherever any form can
    if -(-M // 16) * -(-K // 64) >= H100_SMS:
        assert blocks(M, K, form) >= H100_SMS
    assert str(bm) in serve_fused.serve_form(M, K, D, H100_SMS)


def test_serve_tile_gathers_once_where_the_rows_fill_the_card():
    """A block owns every column tile (each row gathered once) as soon as
    the row tiles alone cover the SMs."""
    for M in (64 * H100_SMS, 10 ** 6):
        bm, tiles = serve_fused.serve_tile(M, 300, 128, H100_SMS)
        assert (bm, tiles) == (64, 5)
    bm, tiles = serve_fused.serve_tile(64 * H100_SMS - 64, 300, 128, H100_SMS)
    assert (bm, tiles) == (32, 5)


@pytest.mark.parametrize("M", [1, 5, 15, 16, 17])
def test_serve_tile_below_one_row_tile(M):
    """M under the smallest tile: 16 rows, one column tile per block."""
    assert serve_fused.serve_tile(M, 172, 256, H100_SMS) == (16, 1)
    assert serve_fused.serve_tile(M, 5, 6, H100_SMS) == (16, 1)


@pytest.mark.parametrize("M,K,D", [(1, 5, 6), (64, 172, 256), (11264, 256, 128),
                                   (2048, 300, 400)])
def test_serve_tile_on_one_sm(M, K, D):
    """One SM is covered by any grid: the largest row tile that fits,
    owning every column tile."""
    bm, tiles = serve_fused.serve_tile(M, K, D, 1)
    fits = [b for b in serve_fused.BMS
            if serve_fused.smem_bytes(b, D) <= serve_fused.SMEM_LIMIT]
    assert (bm, tiles) == (fits[0], -(-K // 64))


def test_serve_tile_at_the_shared_memory_limit():
    """D up to where 16 rows still fit a block; past it the wrapper's
    choice raises, as the wrapper must before any launch."""
    limit = serve_fused.SMEM_LIMIT
    assert serve_fused.smem_bytes(64, 400) > limit      # D=400 drops 64 rows
    assert serve_fused.serve_tile(10 ** 5, 300, 400, H100_SMS)[0] == 32
    d_max = max(D for D in range(1, 4096) if serve_fused.smem_bytes(16, D)
                <= limit)
    assert d_max % 32 == 0 and d_max >= 1024
    assert serve_fused.serve_tile(10 ** 5, 256, d_max, H100_SMS) == (16, 4)
    with pytest.raises(ValueError, match="shared memory"):
        serve_fused.serve_tile(64, 256, d_max + 1, H100_SMS)


@pytest.mark.parametrize("D", [6, 100, 128, 172, 256, 400])
def test_smem_bytes_pads_rows_to_the_staged_depth(D):
    """Rows of the gathered tiles are D rounded up to 32, plus 4 floats."""
    dk = -(-D // 32) * 32
    for bm in serve_fused.BMS:
        assert serve_fused.smem_bytes(bm, D) - serve_fused.smem_bytes(
            bm, dk) == 0
        assert serve_fused.smem_bytes(bm, dk + 1) - serve_fused.smem_bytes(
            bm, dk) == 2 * bm * 32 * 4


@pytest.mark.parametrize("N,sms,want", [
    (176000, H100_SMS, 264), (16000, H100_SMS, 264), (17001, H100_SMS, 264),
    (1000, H100_SMS, 31), (1, H100_SMS, 1), (63, H100_SMS, 1),
    (64, H100_SMS, 2), (176000, 1, 2)])
def test_bwd_stripes(N, sms, want):
    """Two stripes per SM (all resident at once, no ragged wave), none
    under 32 rows."""
    S = update_fused.bwd_stripes(N, sms)
    assert S == want
    rows = -(-N // S)
    assert rows >= min(N, update_fused.BWD_ROWS_MIN)
    assert -(-N // rows) <= S                  # the launch's grid fits


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """The build digest covers the headers a source includes (and theirs),
    so an edited header rebuilds every library that includes it."""
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    assert _build.library_path("k") != second


def test_kernels_a_and_c_share_the_tf32x3_header():
    for name in ("serve_fused", "update_fused"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu",
                                                          "tf32x3.cuh"]


# kernel I at the training paths' frontier sizes (cur rows n) on an H100:
# the rows of a warp's tile picked
DRAW_SHAPES = {"layer 0": (176000, 16), "layer 1": (16000, 2),
               "layer 2": (1000, 1), "ragged": (77, 1),
               "ragged wide": (5001, 1), "4 ranks at layer 0": (704000, 32)}


@pytest.mark.parametrize("path", sorted(DRAW_SHAPES))
def test_draw_group_at_the_path_shapes(path):
    n, want = DRAW_SHAPES[path]
    g = sample_draw.draw_group(n, H100_SMS)
    assert g == want and g in sample_draw.GROUPS
    budget = H100_SMS * sample_draw.TILES_PER_SM
    # the fewest rows a tile within the tile budget (32 past it)
    assert -(-n // g) <= budget or g == 32
    assert g == 1 or -(-n // (g // 2)) > budget


@pytest.mark.parametrize("n,want", [(1, 1), (96, 1), (97, 2), (192, 2),
                                    (193, 4), (3072, 32), (10 ** 7, 32)])
def test_draw_group_on_one_sm(n, want):
    assert sample_draw.draw_group(n, 1) == want


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32])
def test_draw_group_below_one_tile(n):
    """Fewer rows than a warp's lanes: one row a tile, on any card."""
    assert sample_draw.draw_group(n, H100_SMS) == 1
    assert sample_draw.draw_group(n, 1) == 1


# kernel E at the training and offline shapes (M, f, D) on an H100: the
# (rows, slice) form picked
AGG_SHAPES = {"train l0": ((176000, 5, 128), (6, 128)),
              "train l1": ((16000, 10, 256), (3, 256)),
              "train l2": ((1000, 15, 256), (1, 128)),
              "offline": ((2048, 77, 256), (1, 128)),
              "ragged D=6": ((37, 7, 6), (1, 128)),
              "ragged D=100": ((257, 13, 100), (1, 128)),
              "wide D": ((100000, 10, 1024), (3, 1024))}


def agg_warps(M, D, form):
    rows, slice_ = form
    return -(-M // rows) * max(1, -(-D // slice_))


@pytest.mark.parametrize("path", sorted(AGG_SHAPES))
def test_agg_form_at_the_path_shapes(path):
    (M, f, D), want = AGG_SHAPES[path]
    rows, slice_ = form = sage_agg.agg_form(M, f, D, H100_SMS)
    assert form == want
    assert rows >= 1 and slice_ >= sage_agg.SLICE
    assert slice_ % sage_agg.SLICE == 0
    # a warp's rows fill one 32-slot chunk at most
    assert rows == 1 or rows * f <= 32
    budget = H100_SMS * sage_agg.WAVE_WARPS_PER_SM
    if agg_warps(M, D, form) < budget:         # the card still short:
        assert rows == 1                        # rows went first,
        assert slice_ == sage_agg.SLICE         # then the slices


@pytest.mark.parametrize("M,f,D,want", [(176000, 5, 128, (6, 128)),
                                        (1000, 15, 256, (2, 256)),
                                        (40, 1, 6, (1, 128)),
                                        (2048, 77, 256, (1, 256))])
def test_agg_form_on_one_sm(M, f, D, want):
    """On one SM the rows alone make the wave sooner: fewer splits."""
    assert sage_agg.agg_form(M, f, D, 1) == want


@pytest.mark.parametrize("M", [1, 3, 31])
@pytest.mark.parametrize("f,D", [(1, 128), (15, 256), (5, 6), (0, 0)])
def test_agg_form_below_one_warps_rows(M, f, D):
    """Fewer dst rows than one warp would own: one row a warp, and the
    columns in slices of 128 (one slice where D is 128 or less)."""
    rows, slice_ = sage_agg.agg_form(M, f, D, H100_SMS)
    assert (rows, slice_) == (1, sage_agg.SLICE)
