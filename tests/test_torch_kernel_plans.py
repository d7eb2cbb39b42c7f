"""The launch planners of the port's redesigned kernels, on the CPU.

``split_plan`` cuts Q-MAC's K across blocks (``kernels/qmac/ops.py``);
``band_plan`` sizes Q-Conv's bands of output rows and the shared memory
each block stages (``kernels/qconv/ops.py``); ``cell_plan`` cuts a
Q-LSTM step into blocks of batch rows by hidden units
(``kernels/qlstm/ops.py``); ``ew_operand`` decides which views V-ACT's
elementwise kernel reads in place and ``ew_plan`` sizes its launch
(``kernels/vact/ops.py``).  All are pure Python, so the kernels' launch
geometry is checked here; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels.qconv import ops as qconv_ops
from repro_torch.kernels.qconv.ref import same_pads, valid_out
from repro_torch.kernels.qlstm import ops as qlstm_ops
from repro_torch.kernels.qmac import ops as qmac_ops
from repro_torch.kernels.vact import ops as vact_ops

SERVING_BUCKETS = [1, 2, 4, 8, 16, 32]

SPLIT_SHAPES = [(m, k, n) for m in (1, 2, 31, 32, 33, 512)
                for k in (1, 15, 16, 17, 40, 255, 256, 2047, 2048, 2049,
                          131072)
                for n in (1, 4, 33, 128)]


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES[::7] + [(32, 2048, 128)])
def test_split_plan_slices_cover_k_once(m, k, n):
    plan = qmac_ops.split_plan(m, k, n)
    bounds = [(z * plan.slice, min(k, (z + 1) * plan.slice))
              for z in range(plan.splits)]
    assert len(bounds) == plan.splits <= qmac_ops.MAX_SPLITS
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (_, end), (start, _) in zip(bounds, bounds[1:]):
        assert end == start                    # no gap, no overlap
    for start, end in bounds:
        assert end > start or k == 0
    for start, end in bounds[:-1]:
        assert (end - start) % 16 == 0         # whole 16-byte loads
    assert plan.tiles == -(-m // 32) * -(-n // 16)
    want_ws = plan.tiles * plan.splits * 32 * 16 if plan.splits > 1 else 0
    assert plan.workspace == want_ws


@pytest.mark.parametrize("m", SERVING_BUCKETS)
def test_split_plan_fills_the_card_at_the_serving_fc(m):
    """The served fc (K = 2048, N = 128) at every bucket runs about one
    block per SM of an H100 (132)."""
    plan = qmac_ops.split_plan(m, 2048, 128)
    assert plan.splits > 1
    assert 0.9 * 132 <= plan.blocks <= 2 * 132


@pytest.mark.parametrize("m,k,n", [(m, 128, 4) for m in SERVING_BUCKETS]
                         + [(512, 40, 4), (128, 32, 128), (512, 32, 32),
                            (5, 255, 7), (1, 0, 3)]
                         + [(m, k, n) for m in (4, 32)
                            for k, n in ((4, 64), (64, 64), (64, 2),
                                         (64, 1))])
def test_split_plan_takes_one_slice_where_k_is_short(m, k, n):
    """The Q head, the HRL head, the fxp8 PPO actor's four products and
    every product with K under two 128-byte chunks run unsplit: a split
    would only add its reduction."""
    plan = qmac_ops.split_plan(m, k, n)
    assert (plan.splits, plan.slice, plan.workspace) == (1, k, 0)


def test_split_plan_splits_where_the_tiles_leave_the_card_empty():
    # 32 output tiles at the HRL stem fc: four slices, 128 blocks
    assert qmac_ops.split_plan(512, 512, 32).splits == 4
    # enough tiles to fill the card alone: no split
    assert qmac_ops.split_plan(4096, 2048, 512).splits == 1
    with pytest.raises(ValueError):
        qmac_ops.split_plan(0, 16, 4)


def _plan(b, h, w, c, k, n, stride, padding):
    return qconv_ops.band_plan(b, h, w, c, k, k, n, stride, padding)


PLAN_CASES = [
    (32, 32, 32, 12, 3, 16, 2, "SAME"),     # DQN conv1, bucket 32
    (32, 16, 16, 16, 3, 32, 2, "SAME"),     # DQN conv2
    (1, 32, 32, 12, 3, 16, 2, "SAME"),      # DQN conv1, bucket 1
    (512, 32, 32, 3, 3, 16, 2, "SAME"),     # HRL conv1, 512 frames
    (512, 16, 16, 16, 3, 32, 2, "SAME"),    # HRL conv2
    (512, 8, 8, 32, 3, 32, 2, "SAME"),      # HRL conv3
    (2, 13, 11, 130, 5, 48, 1, "SAME"),
    (3, 15, 13, 5, 3, 7, 1, "SAME"),
    (2, 17, 9, 20, 2, 33, 2, "VALID"),
    (1, 7, 7, 12, 5, 3, 3, "VALID"),
    (2, 16, 11, 40, 5, 3, 3, "SAME"),
    (1, 8, 512, 40, 3, 16, 1, "SAME"),      # a band past 48 KB
    (2, 9, 8, 256, 5, 64, 1, "SAME"),       # the N tile must halve
]


def _geometry(h, w, k, stride, padding):
    if padding == "SAME":
        ho, (pt, _) = same_pads(h, k, stride)
        wo, _ = same_pads(w, k, stride)
        return ho, wo, pt
    return valid_out(h, k, stride), valid_out(w, k, stride), 0


@pytest.mark.parametrize("case", PLAN_CASES)
def test_band_plan_covers_rows_once_and_fits_its_shared_memory(case):
    b, h, w, c, k, n, stride, padding = case
    plan = _plan(*case)
    ho, wo, pt = _geometry(h, w, k, stride, padding)
    bands = [(lo, min(ho, lo + plan.rows))
             for lo in range(0, ho, plan.rows)]
    assert bands[0][0] == 0 and bands[-1][1] == ho
    covered = [r for lo, hi in bands for r in range(lo, hi)]
    assert covered == list(range(ho))          # every row once, in order
    assert all(hi - lo <= plan.rows for lo, hi in bands)
    # every band's input rows fit the staged span the smem count assumes
    for lo, hi in bands:
        ih_lo = max(0, lo * stride - pt)
        ih_hi = min(h, (hi - 1) * stride - pt + k)
        assert 0 < ih_hi - ih_lo <= plan.in_rows <= h
    assert plan.smem == qconv_ops.smem_bytes(plan.in_rows, w, c, k, k,
                                             plan.n_tile)
    assert plan.smem <= qconv_ops.SMEM_LIMIT
    n_tiles = -(-n // plan.n_tile)
    assert plan.n_tile % 4 == 0 and n_tiles * plan.n_tile >= n
    assert 128 <= plan.threads <= 256 and plan.threads % 32 == 0
    assert plan.blocks == b * len(bands) * n_tiles


def test_band_plan_smem_counts_the_kernel_layout():
    """Hand counts of qconv.cu's layout: input bytes at C padded to 4
    (+16), fp32 scales (+16), weights at an odd word pitch, each region
    rounded to 16 bytes."""
    # DQN conv1 at bucket 32: 5 input rows of 32 x 12 bytes, 9 taps x 16
    # outputs x 3 words
    plan = _plan(32, 32, 32, 12, 3, 16, 2, "SAME")
    assert (plan.rows, plan.in_rows) == (2, 5)
    assert plan.smem == ((5 * 32 * 12 + 16) + (5 * 32 * 4 + 16)
                         + 9 * 16 * 3 * 4)
    # HRL conv1: C = 3 padded to 4 in shared memory, one word a column
    plan = _plan(512, 32, 32, 3, 3, 16, 2, "SAME")
    assert (plan.rows, plan.in_rows) == (16, 32)
    assert plan.smem == (32 * 32 * 4 + 16) + (32 * 32 * 4 + 16) + 9 * 16 * 4
    # C = 16: four channel words at a pitch of five
    plan = _plan(32, 16, 16, 16, 3, 32, 2, "SAME")
    assert (plan.rows, plan.in_rows) == (1, 3)
    assert plan.smem == ((3 * 16 * 16 + 16) + (3 * 16 * 4 + 16)
                         + 9 * 32 * 5 * 4)


@pytest.mark.parametrize("case,blocks", [
    ((32, 32, 32, 12, 3, 16, 2, "SAME"), 256),
    ((32, 16, 16, 16, 3, 32, 2, "SAME"), 256),
    ((512, 32, 32, 3, 3, 16, 2, "SAME"), 512),
    ((512, 16, 16, 16, 3, 32, 2, "SAME"), 512)])
def test_band_plan_keeps_the_card_full_at_the_stems(case, blocks):
    """About two blocks per SM or more: 256 at the DQN stem's bucket 32,
    where R = 2 rows a band; whole images at 512 HRL frames."""
    assert _plan(*case).blocks == blocks


def test_band_plan_halves_the_n_tile_before_refusing():
    plan = _plan(2, 9, 8, 256, 5, 64, 1, "SAME")
    assert plan.n_tile < 64
    assert plan.blocks == 2 * -(-9 // plan.rows) * -(-64 // plan.n_tile)


def test_band_plan_raises_past_227_kb():
    with pytest.raises(ValueError, match="shared memory"):
        _plan(1, 4, 2048, 40, 3, 16, 1, "SAME")
    # the same rows at 1700 columns still fit one block
    assert _plan(1, 4, 1700, 40, 3, 16, 1, "SAME").smem <= 232448


# --- the Q-LSTM cell's blocks of batch rows x hidden units --------------

CELL_CASES = [(b, d_in, h) for b in (1, 7, 128, 129, 512)
              for h in (1, 3, 32, 33, 64) for d_in in (37, h)]


@pytest.mark.parametrize("b,d_in,h", CELL_CASES)
def test_cell_plan_covers_every_row_and_unit_once(b, d_in, h):
    plan = qlstm_ops.cell_plan(b, d_in, h)
    seen = {}
    for rg in range(plan.row_groups):
        for ug in range(plan.unit_groups):
            for t in range(plan.threads):
                # csrc/qlstm.cu: lane t & 3 is the gate, t >> 2 the pair
                pair = t >> 2
                if pair >= plan.rows * plan.units:
                    continue
                row = rg * plan.rows + pair // plan.units
                unit = ug * plan.units + pair % plan.units
                if row < b and unit < h:
                    seen.setdefault((row, unit), []).append(t & 3)
    assert sorted(seen) == [(r, j) for r in range(b) for j in range(h)]
    assert all(sorted(g) == [0, 1, 2, 3] for g in seen.values())
    assert plan.units == min(h, qlstm_ops.UNITS)
    assert 1 <= plan.rows <= qlstm_ops.MAX_ROWS
    assert plan.threads % 32 == 0 and plan.threads < 4 * plan.rows \
        * plan.units + 32
    assert plan.blocks == plan.row_groups * plan.unit_groups


@pytest.mark.parametrize("b,d_in,h", CELL_CASES[::3] + [(128, 32, 32)])
def test_cell_plan_smem_counts_the_kernel_layout(b, d_in, h):
    """qlstm.cu's ``Layout``: the block's 4 * units gate columns of the
    [Din + H, 4H] stripe at an odd word pitch, then its rows of x and h
    codes at the same pitches."""
    plan = qlstm_ops.cell_plan(b, d_in, h)

    def pitch(k):
        words = -(-k // 4)
        return 4 * (words if words % 2 else words + 1)

    want = (4 * plan.units * (pitch(d_in) + pitch(h))
            + plan.rows * (pitch(d_in) + pitch(h)))
    assert plan.smem == want == qlstm_ops.smem_bytes(d_in, h, plan.rows,
                                                     plan.units)
    assert pitch(d_in) % 8 == 4 and pitch(d_in) >= d_in


def test_cell_plan_fills_the_card_at_the_agent_shape():
    """The LSTM-HRL step (B = 128 windows, Din = H = 32): 128 blocks of
    4 rows x 8 units, not the 16 blocks a block of 8 rows over all units
    gave."""
    plan = qlstm_ops.cell_plan(128, 32, 32)
    assert (plan.rows, plan.units, plan.threads) == (4, 8, 128)
    assert plan.blocks == 128
    assert qlstm_ops.cell_plan(512, 32, 32).rows == 8
    assert qlstm_ops.cell_plan(1, 32, 32).blocks == 4


def test_cell_plan_raises_past_227_kb():
    # 8 units' columns over Din = 8192 codes: 33 x (8196 + 12) bytes
    with pytest.raises(ValueError, match="shared memory"):
        qlstm_ops.cell_plan(1, 8192, 8)
    assert qlstm_ops.cell_plan(1, 5000, 8).smem <= \
        qlstm_ops.SMEM_BUDGET_BYTES
    with pytest.raises(ValueError):
        qlstm_ops.cell_plan(0, 32, 32)


# --- which views V-ACT's elementwise kernel reads in place --------------

def _views():
    base = torch.zeros((128, 128))
    return {
        "contiguous": (torch.zeros((512, 8)), (1, 4096, 4096)),
        "gate slice": (base[:, 32:64], (128, 32, 128)),
        "last gate": (base[:, 96:128], (128, 32, 128)),
        "3-D slice": (torch.zeros((2, 3, 10))[:, :, 1:5], (6, 4, 10)),
        "width-1 column": (torch.zeros((3, 10))[:, 2:3], (3, 1, 10)),
        "broadcast rows": (torch.zeros((1, 8)).expand(4, 8), (4, 8, 0)),
        "size-1 lead": (torch.zeros((1, 5, 12))[:, :, :7], (5, 7, 12)),
        "0-d": (torch.zeros(()), (1, 1, 1)),
        "odd offset": (torch.zeros(37)[1:34], (1, 33, 33)),
        "transposed": (torch.zeros((4, 6)).t(), None),
        "strided last axis": (torch.zeros((4, 8))[:, ::2], None),
        "leading axes apart": (torch.zeros((2, 3, 10))[:, :2, :4], None),
        "broadcast middle": (torch.zeros((2, 1, 8)).expand(2, 3, 8), None),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_ew_operand_passes_views_without_a_copy(name):
    x, want = _views()[name]
    got = vact_ops.ew_operand(tuple(x.shape), x.stride())
    assert got == want
    if got is None:
        return
    rows, cols, ld = got
    assert rows * cols == x.numel()
    # the kernel's addressing reads exactly the view's elements, in order
    flat = torch.arange(x.untyped_storage().nbytes() // 4,
                        dtype=torch.float32)
    view = flat.as_strided(x.shape, x.stride(), x.storage_offset())
    idx = torch.tensor([x.storage_offset() + r * ld + c
                        for r in range(rows) for c in range(cols)])
    assert torch.equal(flat[idx], view.reshape(-1))


WAVE = 132 * 256               # one wave of one-element threads
CAP = vact_ops.EW_MAX_BLOCKS * vact_ops.EW_MAX_THREADS  # grid strides past


@pytest.mark.parametrize("n", [1, 3, 4095, 4096, 4097, WAVE, WAVE + 1,
                               CAP + 1])
def test_ew_plan_gives_each_element_one_thread(n):
    """Whole warps, at most EW_MAX_THREADS a block, and blocks for every
    element up to the grid's cap, past which the grid strides."""
    plan = vact_ops.ew_plan(n)
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads <= vact_ops.EW_MAX_THREADS
    assert plan.blocks == min(-(-n // plan.threads),
                              vact_ops.EW_MAX_BLOCKS)
    assert plan.threads * plan.blocks >= min(n, CAP)
    # no block could be dropped: the last one holds an element
    assert (plan.blocks - 1) * plan.threads < n


def test_ew_plan_spreads_small_tensors_over_many_sms():
    """The path's 4096-element calls run in one-warp blocks on 128 SMs,
    where 256 threads a block ran 16 blocks; a large tensor takes full
    blocks and a capped grid that strides."""
    assert vact_ops.ew_plan(128 * 32) == vact_ops.EwPlan(32, 128)
    big = vact_ops.ew_plan(1 << 26)
    assert big.threads == vact_ops.EW_MAX_THREADS
    assert big.blocks == vact_ops.EW_MAX_BLOCKS
    with pytest.raises(ValueError):
        vact_ops.ew_plan(0)


# --- V-ACT's softmax: which kernel, and which views it reads in place ---

@pytest.mark.parametrize("cols", range(1, 33))
def test_softmax_plan_takes_the_rows_kernel_up_to_a_warp(cols):
    """cols <= 32: lanes a row a power of two at or above cols, whole
    warps, and enough of them for every row up to the grid's cap."""
    for rows in (1, 7, 128, 512, 10 ** 6):
        plan = vact_ops.softmax_plan(rows, cols)
        assert plan.regime == "rows" and plan.staged == 0
        lanes = plan.lanes
        assert lanes & (lanes - 1) == 0 and cols <= lanes < 2 * cols
        assert plan.threads % 32 == 0
        assert 32 <= plan.threads <= vact_ops.EW_MAX_THREADS
        warps = plan.threads * plan.blocks // 32
        assert plan.blocks == vact_ops.EW_MAX_BLOCKS or \
            warps * (32 // lanes) >= rows
        # no block could be dropped
        assert (plan.blocks - 1) * plan.threads // 32 * (32 // lanes) < rows


def test_softmax_plan_spreads_the_agents_heads_over_many_sms():
    """FC-HRL's [512, 4] runs 8 rows a warp in one-warp blocks on 64 SMs,
    not 64 warps of 28 idle lanes; LSTM-HRL's [128, 4] on 16."""
    assert vact_ops.softmax_plan(512, 4) == vact_ops.SoftmaxPlan(
        "rows", 4, 32, 64)
    assert vact_ops.softmax_plan(128, 4) == vact_ops.SoftmaxPlan(
        "rows", 4, 32, 16)


@pytest.mark.parametrize("cols,regime,threads", [
    (32, "rows", 32), (33, "block", 32), (1023, "block", 32),
    (1024, "block", 32), (1025, "block", 64), (58079, "block", 1024),
    (58080, "block", 1024), (58081, "block", 1024), (65536, "block", 1024)])
def test_softmax_plan_bounds(cols, regime, threads):
    """The rows kernel up to 32 elements; the block kernel past that,
    one warp a row up to 32 elements a lane (1024), then
    ``next_pow2(cols / 32)`` threads up to 1024."""
    plan = vact_ops.softmax_plan(7, cols)
    assert plan.regime == regime and plan.threads == threads
    if regime == "block":
        assert plan.lanes == 0
        assert 32 * plan.threads >= min(cols, 32 * 1024)
        assert plan.threads == 32 or 16 * plan.threads < cols
        assert plan.blocks == 7


@pytest.mark.parametrize("cols", [1025, 8192, 58079, 58080])
def test_softmax_plan_stages_a_row_that_fits_shared_memory(cols):
    plan = vact_ops.softmax_plan(4096, cols)
    assert plan.regime == "block" and plan.staged == cols
    assert plan.smem == 4 * cols + vact_ops.SOFTMAX_SCRATCH
    assert plan.smem <= 232448
    assert plan.blocks == min(4096, vact_ops.EW_MAX_BLOCKS)


@pytest.mark.parametrize("cols", [58081, 65536, 1 << 20])
def test_softmax_plan_reads_a_row_past_shared_memory_again(cols):
    """A row past 227 KB stages what fits (58,080 floats beside the
    32-float scratch) and reads the rest again, in the same kernel."""
    plan = vact_ops.softmax_plan(256, cols)
    assert plan.regime == "block" and plan.threads == 1024
    assert plan.staged == vact_ops.SOFTMAX_STAGE_MAX == 58080
    assert plan.smem == 232448
    assert cols - plan.staged == {58081: 1, 65536: 7456}.get(
        cols, cols - 58080)


def test_softmax_plan_refuses_what_the_kernels_do_not_take():
    for rows, cols in ((0, 4), (4, 0), (1, vact_ops.SOFTMAX_MAX_COLS + 1)):
        with pytest.raises(ValueError):
            vact_ops.softmax_plan(rows, cols)


def _softmax_views():
    base = torch.zeros((128, 130))
    return {
        "contiguous [512, 4]": (torch.zeros((512, 4)), (512, 4, 4)),
        "contiguous 3-D": (torch.zeros((3, 5, 11)), (15, 11, 11)),
        "1-D": (torch.zeros(7), (1, 7, 7)),
        "column": (torch.zeros((4, 1)), (4, 1, 1)),
        "row stride 130": (base[:, 2:34], (128, 32, 130)),
        "rows of 4 of 8": (torch.zeros((2, 8))[:, :4], (2, 4, 8)),
        "3-D slice": (torch.zeros((4, 32, 12))[:, :, 4:8], (128, 4, 12)),
        "width-1 column": (torch.zeros((3, 10))[:, 2:3], (3, 1, 10)),
        "broadcast rows": (torch.zeros((1, 8)).expand(4, 8), (4, 8, 0)),
        "transposed": (torch.zeros((4, 6)).t(), None),
        "strided last axis": (torch.zeros((4, 8))[:, ::2], None),
        "leading axes apart": (torch.zeros((2, 3, 10))[:, :2, :4], None),
    }


@pytest.mark.parametrize("name", list(_softmax_views()))
def test_softmax_operand_reads_rows_of_the_last_axis(name):
    """A softmax row is the last axis: a contiguous tensor is numel/cols
    rows at ld = cols, a view is read at its folded row stride, and the
    kernel's addressing reads exactly the view's rows, in order."""
    x, want = _softmax_views()[name]
    got = vact_ops.softmax_operand(tuple(x.shape), x.stride())
    assert got == want
    if got is None:
        return
    rows, cols, ld = got
    assert cols == x.shape[-1] and rows * cols == x.numel()
    flat = torch.arange(x.untyped_storage().nbytes() // 4,
                        dtype=torch.float32)
    view = flat.as_strided(x.shape, x.stride(), x.storage_offset())
    idx = torch.tensor([x.storage_offset() + r * ld + c
                        for r in range(rows) for c in range(cols)])
    assert torch.equal(flat[idx], view.reshape(-1))


# --- V-ACT's int8 kernel: the grid over 16-byte chunks ------------------

WAVE_Q8 = 256 * 6 * 132 * 16          # one chunk a thread, one wave


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 1 << 20, WAVE_Q8,
                               WAVE_Q8 + 1, 1 << 26, (1 << 26) + 3,
                               1 << 34])
def test_q8_plan_covers_every_element_within_the_grid_cap(n):
    plan = vact_ops.q8_plan(n)
    assert plan.threads == vact_ops.Q8_THREADS == 256
    assert 1 <= plan.blocks <= vact_ops.Q8_MAX_BLOCKS
    assert plan.threads * plan.blocks * plan.items * 16 >= n
    # below the cap no block to spare, at it no chunk a thread to spare
    if plan.blocks < vact_ops.Q8_MAX_BLOCKS:
        assert plan.items == (1 if n <= WAVE_Q8 else vact_ops.Q8_ITEMS)
        assert (plan.blocks - 1) * plan.threads * plan.items * 16 < n
    else:
        assert plan.threads * plan.blocks * (plan.items - 1) * 16 < n


def test_q8_plan_runs_small_tensors_in_one_block_and_large_ones_in_items():
    """[512, 8] is 256 chunks: one block, a chunk a thread, one table;
    2^26 elements take four chunks a thread over 4096 blocks, and
    2^34 stride over the capped grid."""
    assert vact_ops.q8_plan(512 * 8) == vact_ops.Q8Plan(256, 1, 1)
    assert vact_ops.q8_plan(1 << 26) == vact_ops.Q8Plan(256, 4096, 4)
    huge = vact_ops.q8_plan(1 << 34)
    assert huge.blocks == vact_ops.Q8_MAX_BLOCKS == 16 * 6 * 132
    with pytest.raises(ValueError):
        vact_ops.q8_plan(0)


@pytest.mark.parametrize("batch,m,k,n", [(128, 4, 2048, 768),
                                         (128, 4, 768, 2048),
                                         (128, 320, 2048, 768),
                                         (8, 10, 6144, 16384),
                                         (2, 5, 2048, 40),
                                         (1, 7, 2048, 128)])
def test_split_plan_counts_every_experts_tiles(batch, m, k, n):
    """A batched product's plan counts the tiles of all its experts (the
    workspace and counters are sized from it); qwen3-moe's expert
    products fill the card without a split; one expert is the plain
    product's plan."""
    plan = qmac_ops.split_plan(m, k, n, batch)
    assert plan.tiles == batch * -(-m // 32) * -(-n // 16)
    if batch == 128:
        assert plan.splits == 1 and plan.workspace == 0
    if batch == 1:
        assert plan == qmac_ops.split_plan(m, k, n)
    if (batch, m, n) == (2, 5, 40):
        assert plan.splits > 1
        assert plan.workspace == plan.tiles * plan.splits * 32 * 16


def test_split_plan_refuses_more_than_65535_row_tiles_over_experts():
    """The experts share the grid's row axis with the row tiles."""
    assert qmac_ops.split_plan(32, 64, 16, 65535).tiles == 65535
    with pytest.raises(ValueError, match="65535 row tiles"):
        qmac_ops.split_plan(32, 64, 16, 65536)
    with pytest.raises(ValueError, match="65535 row tiles"):
        qmac_ops.split_plan(33, 64, 16, 32768)
    with pytest.raises(ValueError, match="batch >= 1"):
        qmac_ops.split_plan(4, 64, 16, 0)


@pytest.mark.parametrize("kernel,alias,name", [
    ("qmac", "ref_qmac_i8", "qmac_i8"),
    ("qmac", "ref_qmac_i8_deq", "qmac_i8_deq"),
    ("qconv", "ref_qconv2d_i8", "qconv2d_i8"),
    ("vact", "ref_vact", "vact"),
    ("vact", "ref_vact_q8", "vact_q8"),
    ("qlstm", "ref_qlstm_cell", "qlstm_cell")])
def test_ops_reexport_their_oracles(kernel, alias, name):
    """Each ``ops`` module names its plain oracle as the reference's
    ``ops`` does (``ref_<kernel>``): the ``ref.py`` function itself."""
    import importlib
    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    ref = importlib.import_module(f"repro_torch.kernels.{kernel}.ref")
    jops = importlib.import_module(f"repro.kernels.{kernel}.ops")
    assert getattr(ops, alias) is getattr(ref, name)
    assert hasattr(jops, alias)
