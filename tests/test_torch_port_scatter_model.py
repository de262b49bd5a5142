"""A model in numpy of the card's ordered scatter (``csrc/hash_scatter.cu``),
step by step as the kernels run it, held bit for bit to
``np.argsort(kind="stable")`` and to ``np.add.at``.

The sort: keys outside [0, m) become the sentinel m; one histogram of
every pass's digits; the tile's digit counts (published before the
ranking); passes of ``digit_bits`` over bit_length(m) bits;
in each pass tiles of ``warps`` x 32 lanes x ``items`` keys, ranked warp
by warp, 32 keys at a time (the lanes of one digit, found by ballots,
counted together), the tile's digit offsets from the digit
counts of the tiles before it (what the decoupled look-back adds up) and
the pass's digit offsets. The sum: chunks of 32 x ``sum_items`` sorted
positions; segments that end inside a chunk summed one per lane, the
chunk's last one (which may run on into the next chunks) by the whole
warp, its part in the chunk first, then loads of 32 x ``coop``
positions; every row's adds one chain in index order. The kernel's own sizes are
read from its source.
"""
import os
import re

import numpy as np
import pytest
import torch

from level_s2fm_tpu_torch import kernels
from level_s2fm_tpu_torch.fields import hash_scatter as hs


def kernel_sizes():
    """The kernels' sizes, read from the constants of
    ``csrc/hash_scatter.cu`` (no build here): warps and keys a thread of a
    sort tile, digit bits, 32-position loads of a segment-sum chunk and of
    a long segment; and the tile (warps x 32 x items)."""
    with open(os.path.join(kernels.CSRC, "hash_scatter.cu")) as f:
        src = f.read()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    sizes = {"warps": get("kSortWarps"), "items": get("kSortItems"),
             "digit_bits": get("kRadixBits"), "sum_items": get("kSumItems"),
             "coop": get("kCoop")}
    return {**sizes, "tile": sizes["warps"] * 32 * sizes["items"]}


KERNEL = kernel_sizes()
#: a smaller tile and chunk, so that short inputs cross many of them
SMALL = {"warps": 2, "items": 2, "digit_bits": 8, "sum_items": 1, "coop": 1, "tile": 128}


def model_sort(gi, m, warps, items, digit_bits, tile, **_):
    """(sorted keys, their contribution indices) as the kernels make them."""
    n = len(gi)
    keys = np.where((gi >= 0) & (gi < m), gi, m).astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    radix = 1 << digit_bits
    passes = max(1, -(-int(m).bit_length() // digit_bits))
    hist = [np.bincount((keys >> (p * digit_bits)) & (radix - 1), minlength=radix)
            for p in range(passes)]
    assert tile == warps * 32 * items
    lower = np.tril(np.ones((32, 32), bool), -1)       # lane l' < lane l
    rows = np.arange(warps)[:, None]
    for p in range(passes):
        shift = p * digit_bits
        pass_start = np.cumsum(hist[p]) - hist[p]
        before_tile = np.zeros(radix, np.int64)
        out_k, out_i = np.empty_like(keys), np.empty_like(idx)
        for t0 in range(0, n, tile):
            k, pl = keys[t0:t0 + tile], idx[t0:t0 + tile]
            d = np.full(tile, radix, np.int64)          # past the end: no digit
            d[:len(k)] = (k >> shift) & (radix - 1)
            d = d.reshape(warps, items, 32)             # element w*32*items + it*32 + lane
            warp_hist = np.zeros((warps, radix + 1), np.int64)
            rank = np.empty_like(d)
            for it in range(items):
                di = d[:, it]
                peers = di[:, :, None] == di[:, None, :]
                rank[:, it] = warp_hist[rows, di] + (peers & lower).sum(-1)
                np.add.at(warp_hist, (np.broadcast_to(rows, di.shape), di), 1)
            count = warp_hist[:, :radix].sum(0)
            warp_before = np.cumsum(warp_hist[:, :radix], 0) - warp_hist[:, :radix]
            local = np.cumsum(count) - count
            d, rank = d.reshape(warps, -1), rank.reshape(warps, -1)
            w = np.broadcast_to(rows, d.shape)
            valid = d < radix
            pos = (local[np.minimum(d, radix - 1)] + warp_before[w, np.minimum(d, radix - 1)]
                   + rank)[valid]
            assert np.array_equal(np.sort(pos), np.arange(len(k)))   # a permutation
            staged_k, staged_i = np.empty_like(k), np.empty_like(pl)
            staged_k[pos], staged_i[pos] = k, pl
            sd = (staged_k >> shift) & (radix - 1)
            dest = pass_start[sd] + before_tile[sd] + np.arange(len(k)) - local[sd]
            out_k[dest], out_i[dest] = staged_k, staged_i
            before_tile += count
        keys, idx = out_k, out_i
    return keys, idx


def model_sum(keys, idx, g, m, sum_items, coop, **_):
    """out [m, F]: the sorted segments' row sums, as the segment-sum
    kernel adds them (float32, each row one chain in index order)."""
    n, F = g.shape
    out = np.zeros((m, F), np.float32)
    chunk = 32 * sum_items
    for c0 in range(0, n, chunk):
        p = np.arange(c0, min(n, c0 + chunk))
        start = (p == 0) | (keys[p] != keys[np.maximum(p - 1, 0)])
        starts = list(p[start]) + [p[-1] + 1]
        if len(starts) == 1:
            continue
        for s, e in zip(starts[:-2], starts[1:-1]):    # one lane each
            if keys[s] < m:
                acc = np.zeros(F, np.float32)
                for q in range(s, e):
                    acc += g[idx[q]]
                out[keys[s]] = acc
        key = keys[starts[-2]]                          # the last: the whole warp
        if key >= m:
            continue
        acc = np.zeros(F, np.float32)
        for q in range(starts[-2], starts[-1]):
            acc += g[idx[q]]
        base, open_ = starts[-1], True
        while open_:
            for c in range(coop):
                lanes = base + c * 32 + np.arange(32)
                live_mask = (lanes < n) & (keys[np.minimum(lanes, n - 1)] == key)
                live = int(live_mask.sum())
                assert live_mask[:live].all()            # a prefix of the lanes
                for q in lanes[:live]:                   # the shuffle chain
                    acc += g[idx[q]]
                if live < 32:
                    open_ = False
                    break
            base += 32 * coop
        out[key] = acc
    return out


def _case(name, n, m, F, seed):
    """Keys and cotangents of one edge shape (``_inputs``'s spread of
    binades, so that the order of a sum shows in its bits)."""
    rng = np.random.default_rng(seed)
    if name == "all_equal":
        gi = np.full(n, m - 1, np.int64)
    elif name == "long_segment":                       # one row of 3,400 among others
        gi = np.concatenate([np.full(3400, m // 3), rng.integers(0, m, n - 3400)])
        gi = gi[rng.permutation(n)]
    elif name == "out_of_range":
        gi = rng.integers(-40, m + 40, n)
        gi[::7] = rng.choice([-2 ** 40, 2 ** 40, m, -1], len(gi[::7]))
    else:
        gi = rng.integers(0, m, n)
    g = (rng.standard_normal((n, F)) * np.exp2(rng.integers(-8, 8, (n, 1)))).astype(np.float32)
    return gi.astype(np.int64), g


def edge_cases(tile):
    """(name, n, m, F) at the edge shapes for a tile of ``tile`` keys."""
    return [("random", 0, 5, 2), ("random", 1, 1, 1), ("random", tile - 1, 2 ** 12, 2),
            ("random", tile + 1, 2 ** 12 + 1, 4), ("random", tile + 1, 1, 8),
            ("all_equal", 2 * tile + 3, 300, 1), ("long_segment", 3600, 2 ** 16 + 1, 2),
            ("out_of_range", tile + 1, 1000, 2), ("random", 3000, 2 ** 24 + 1, 1)]


def _reference(gi, g, m):
    """np.add.at over the in-range keys, in index order."""
    keep = (gi >= 0) & (gi < m)
    want = np.zeros((m, g.shape[1]), np.float32)
    np.add.at(want, gi[keep], g[keep])
    return want


@pytest.mark.parametrize("sizes", [KERNEL, SMALL], ids=["kernel_sizes", "small_tiles"])
@pytest.mark.parametrize("case", range(9))
def test_model_is_the_stable_sort_and_the_ordered_sum(sizes, case):
    name, n, m, F = edge_cases(sizes["tile"])[case]
    gi, g = _case(name, n, m, F, seed=case)
    keys, idx = model_sort(gi, m, **sizes)
    sentinel = np.where((gi >= 0) & (gi < m), gi, m)
    order = np.argsort(sentinel, kind="stable")
    assert np.array_equal(idx, order)
    assert np.array_equal(keys, sentinel[order])
    got = model_sum(keys, idx, g, m, **sizes)
    want = _reference(gi, g, m)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if name != "out_of_range":   # index_add_ refuses such keys
        plain = hs.ordered_scatter_add(torch.as_tensor(gi), torch.as_tensor(g), m)
        assert np.array_equal(plain.numpy().view(np.int32), want.view(np.int32))


def test_passes_follow_the_rows():
    """bit_length(m) bits, the sentinel m included: 3 passes of 8 bits for
    the hash grid's 16 x 2^19 rows, 4 from 2^24 rows."""
    passes = lambda m: max(1, -(-int(m).bit_length() // KERNEL["digit_bits"]))
    assert [passes(m) for m in (1, 255, 256, 16 * 2 ** 19, 2 ** 24 - 1, 2 ** 24)] == \
        [1, 1, 2, 3, 3, 4]
