"""The flagship kernel's launch shape: how the chunks of G images are cut
into blocks (``ops/flagship.py:split_chunks``), a pure function of the
shapes and the card, held here on the CPU for an H100's 132 SMs at one
resident block per SM."""
import pytest

from awesome_tpu_torch.ops import flagship as TP

SMS, PER_SM = 132, 1
# chunks of 64 points per image at 480x640 and at 64x64
CHUNKS = {"480x640": 480 * 640 // 64, "64x64": 64 * 64 // 64}


@pytest.mark.parametrize("image", sorted(CHUNKS))
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 33])
def test_split_chunks_fits_one_wave_and_covers_every_chunk(image, group):
    """All G images' blocks fit in one wave of resident blocks, and the
    tiles of an image cover each of its chunks once: the last tile is not
    empty."""
    n_chunks = CHUNKS[image]
    chunks, n_tiles = TP.split_chunks(n_chunks, group, SMS, PER_SM)
    assert group * n_tiles <= SMS * PER_SM
    assert chunks * (n_tiles - 1) < n_chunks <= chunks * n_tiles


@pytest.mark.parametrize("group,want", [(1, (37, 130)), (8, (300, 16)),
                                        (2, (73, 66)), (4, (146, 33))])
def test_split_chunks_at_full_resolution(group, want):
    """At 480x640 (4,800 chunks): G = 1 keeps its 130 tiles of 37 chunks;
    G = 8 takes 16 tiles of 300 (128 blocks), where a wave's worth of
    chunks per block (291) took 17 tiles and 136 blocks; G = 2 and 4 (the
    mesh's ranks) keep their shapes."""
    assert TP.split_chunks(4800, group, SMS, PER_SM) == want


def test_split_chunks_edges():
    """More images than blocks in a wave: one tile per image. A fixed
    number of chunks per block (the ``tile_n`` hint) is kept. Fewer chunks
    than SMs: one chunk per block. Two resident blocks per SM double the
    slots."""
    assert TP.split_chunks(64, 200, SMS, PER_SM) == (64, 1)
    assert TP.split_chunks(4800, 1, SMS, PER_SM, tile_chunks=100) == (100, 48)
    assert TP.split_chunks(7, 1, SMS, PER_SM) == (1, 7)
    assert TP.split_chunks(4800, 8, SMS, 2) == (146, 33)
