"""The host side of the CUDA kernels' launches, on the CPU: which
instantiation of W a call takes and how many persistent blocks its grid
has, for a fake SM count and residency (``ops/cuda_gossip.py``).  The kernels themselves
are held against their plain versions on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch

from go_libp2p_pubsub_torch.ops.cuda_gossip import (
    LaunchShape, grid_blocks, kernel_variant)

# The W = 4 instantiations' launch shape on an H100: a thread a peer,
# 128-peer tiles, 6 blocks an SM; and a card of 132 SMs.
SHAPE = LaunchShape(tile_peers=128, blocks_per_sm=6)
SMS = 132


@pytest.mark.parametrize("w", [1, 2, 4, 8, 16])
def test_vector_widths_take_their_own_instantiation(w):
    assert kernel_variant(w, [0, 4096, None]) == w


@pytest.mark.parametrize("w", [3, 5, 6, 12, 40])
def test_other_widths_take_the_generic_instantiation(w):
    assert kernel_variant(w, [0, 4096]) == 0


@pytest.mark.parametrize("w,address,variant", [
    (4, 8, 0), (4, 4, 0), (8, 32 + 8, 0),  # 16-byte vectors
    (16, 64 + 4, 0), (16, 64 + 16, 16),
    (2, 4, 0), (2, 8, 2),                  # 8-byte vectors
    (1, 4, 1),                             # a word needs a word's alignment
])
def test_misaligned_vector_reads_take_the_generic_instantiation(
        w, address, variant):
    assert kernel_variant(w, [0, address]) == variant


def test_a_row_offset_view_is_misaligned_for_wide_rows():
    """A contiguous view that starts one row in: 4-word rows from word 1 on
    are not 16-byte aligned, so the generic instantiation reads them."""
    table = torch.zeros((9, 4), dtype=torch.int32)
    assert kernel_variant(4, [table.data_ptr()]) == 4
    assert kernel_variant(4, [table.view(-1)[1:].data_ptr()]) == 0


@pytest.mark.parametrize("n,sms,bps,grid", [
    (1, SMS, 6, 1),                      # fewer peers than one tile
    (127, SMS, 6, 1), (128, SMS, 6, 1),  # one tile,
    (129, SMS, 6, 2),                    # then a ragged second
    (589, SMS, 6, 5),
    (100_000, SMS, 6, 782),              # the headline: one tile a block
    (128 * 792, SMS, 6, 792),            # one tile for every resident block
    (2 * 792 * 128 + 17, SMS, 6, 792),   # several tiles a block, ragged last
    (1000, SMS, 2, 8),
    (2 * 264 * 128 + 17, SMS, 2, 264),   # fewer resident blocks an SM
    (1000, 8, 2, 8), (2 * 16 * 128 + 17, 8, 2, 16),   # a small card
    (273, 1, 1, 1), (1000, 1, 1, 1),     # one block walks every tile
])
def test_grid_is_one_block_a_tile_up_to_the_resident_blocks(n, sms, bps, grid):
    assert grid_blocks(n, SHAPE._replace(blocks_per_sm=bps), sms) == grid


def test_the_zero_peer_call_still_has_a_block():
    assert grid_blocks(0, SHAPE, SMS) == 1

