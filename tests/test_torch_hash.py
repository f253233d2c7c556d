"""The PyTorch port's hash-grid encode and SH encoding against the JAX
package, on the CPU (the port's plain version; the CUDA kernels are held
against it on the card in tests/test_torch_gpu.py).

The grid has dense and hashed levels: 4 levels, 2^12 rows, resolutions 4,
8, 16, 32, of which 4 and 8 index densely.  Positions include 0, 1 and
grid vertices k/res, which pin the floor and the dense clip.  Tolerances
as tests/test_pallas_hash.py: rtol 1e-5, atol 1e-6 for values and the
table gradient, 1e-5 for the position gradient.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops import hashgrid as jhash
from cropnerf_tpu.ops.pallas.hash_encode import hashgrid_encode_pallas
from cropnerf_tpu.ops.sh import sh_encoding as jax_sh
from cropnerf_tpu_torch.ops import hashgrid as thash
from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
from cropnerf_tpu_torch.ops.sh import sh_encoding as torch_sh

LOG2_T = 12
T = 2 ** LOG2_T
RES = (4, 8, 16, 32)
N = 1024


def _positions(seed=0, n=N):
    """Uniform positions with boundary rows: 0, 1, vertices k/res of every
    level, and mixes of them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    edges = [np.zeros(3), np.ones(3), [1, 0, 0.5], [0, 1, 1]]
    for r in RES:
        k = rng.integers(0, r + 1, (6, 3))
        edges += list(k / r)
    pos[:len(edges)] = np.asarray(edges, np.float32)
    return pos


def _table(layout, hash_mode="auto", seed=1, res=RES):
    rng = np.random.default_rng(seed)
    if layout == "dense":
        shape = (len(res), T, 2)
    else:
        shape = (sum(jhash.level_row_counts(res, T, hash_mode)), 2)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def test_grid_layout_helpers_match_jax():
    assert thash.level_resolutions(4, 4, 32) == RES
    for args in ((16, 16, 2048), (5, 16, 128), (5, 16, 256), (3, 16, 32),
                 (1, 16, 64)):
        assert thash.level_resolutions(*args) == jhash.level_resolutions(*args)
    for res in (4, 8, 15, 16, 32, 64, 127):
        for t in (2 ** 10, 2 ** 12, 2 ** 19):
            assert thash.level_uses_dense(res, t) == jhash.level_uses_dense(
                res, t)
    for mode in ("auto", "hash"):
        assert thash.level_row_counts(RES, T, mode) == jhash.level_row_counts(
            RES, T, mode)
        for packed in (True, False):
            assert thash._level_offsets(RES, T, mode, packed) == \
                jhash._level_offsets(RES, T, mode, packed)
    # the cropnerf field: 5 dense levels, 6,098,925 packed rows
    field = jhash.level_resolutions(16, 16, 2048)
    assert sum(thash.level_row_counts(field, 2 ** 19)) == 6_098_925
    assert sum(thash.level_uses_dense(r, 2 ** 19) for r in field) == 5


def test_dense_layout_matches_pallas_kernel_interpret():
    """The Pallas kernel K4 takes the dense [L, T, F] layout."""
    table, pos = _table("dense"), _positions()
    ref = hashgrid_encode_pallas(jnp.asarray(table), jnp.asarray(pos), RES,
                                 128, True)
    got = thash.hashgrid_encode(torch.from_numpy(table),
                                torch.from_numpy(pos), RES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("hash_mode,cell_pack", [("auto", False),
                                                 ("auto", True),
                                                 ("hash", False)])
def test_packed_layout_matches_hashgrid_encode(hash_mode, cell_pack):
    table, pos = _table("packed", hash_mode), _positions(seed=2)
    ref = jhash.hashgrid_encode(jnp.asarray(table), jnp.asarray(pos), RES,
                                hash_mode, T, cell_pack)
    got = thash.hashgrid_encode(torch.from_numpy(table),
                                torch.from_numpy(pos), RES, hash_mode, T,
                                cell_pack)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_batched_positions_keep_their_shape():
    table = torch.from_numpy(_table("packed"))
    pos = torch.from_numpy(_positions(n=96)).reshape(4, 24, 3)
    out = thash.hashgrid_encode(table, pos, RES, table_size=T)
    assert out.shape == (4, 24, 2 * len(RES))
    flat = thash.hashgrid_encode(table, pos.reshape(-1, 3), RES, table_size=T)
    assert torch.equal(out.reshape(-1, out.shape[-1]), flat)


@pytest.mark.parametrize("layout,hash_mode", [("packed", "auto"),
                                              ("dense", "auto"),
                                              ("packed", "hash")])
def test_gradients_match_jax(layout, hash_mode):
    """d table and d positions against jax.vjp through hashgrid_encode
    (the custom VJP: flat scatters and the analytic position gradient)."""
    table, pos = _table(layout, hash_mode, seed=3), _positions(seed=4)
    cot = np.random.default_rng(5).standard_normal(
        (N, 2 * len(RES))).astype(np.float32)
    _, vjp = jax.vjp(lambda t, p: jhash.hashgrid_encode(t, p, RES, hash_mode,
                                                        T),
                     jnp.asarray(table), jnp.asarray(pos))
    ref_t, ref_p = vjp(jnp.asarray(cot))
    tt = torch.from_numpy(table).requires_grad_(True)
    tpos = torch.from_numpy(pos).requires_grad_(True)
    thash.hashgrid_encode(tt, tpos, RES, hash_mode, T).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref_t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tpos.grad.numpy(), np.asarray(ref_p),
                               rtol=1e-5, atol=1e-5)


# the levels whose table gradient the kernel sums in shared memory first,
# per grid (the field, then each proposal net) of each preset, and for the
# dense [L, T, F] layout of this file's grid
PRIVATE_CASES = {
    "cropnerf": [(0, 1), (0, 1), (0,)],
    "cropnerf-huge": [(0, 1), (0,), (0,)],
    "cropnerf-tiny": [(), ()],
    "dense-layout": [(0, 1)],
}


@pytest.mark.parametrize("case", list(PRIVATE_CASES))
def test_private_levels_follow_the_layout(case):
    """Dense levels whose (res+1)^3 rows of 8 bytes fit one block's shared
    memory (232,448 bytes), whatever the preset: for cropnerf the field's
    levels 0-1 (39,304 and 97,336 bytes; level 2 needs 238,328), proposal
    0's levels 0-1 (157,464 bytes) and proposal 1's level 0."""
    from cropnerf_tpu_torch.models.config import PRESETS
    if case == "dense-layout":
        layouts = [(RES, T)]
    else:
        m = PRESETS[case].model
        layouts = [(thash.level_resolutions(gc.num_levels, gc.min_res,
                                            gc.max_res),
                    2 ** gc.log2_hashmap_size)
                   for gc in [m.field.grid] + [p.grid for p in
                                               m.proposal_fields]]
    got = []
    for res, t in layouts:
        dense = [thash.level_uses_dense(r, t) for r in res]
        priv = khash.private_levels(res, dense)
        assert all(dense[l] and (res[l] + 1) ** 3 * 8 <= 232_448
                   for l in priv)
        got.append(priv)
    assert got == PRIVATE_CASES[case]
    assert khash.private_levels(RES, [True] * 4, smem_bytes=729 * 8) == (0, 1)


def _table_pass_model(table2d, pos, cot, res, offsets, dense, t, blocks,
                      threads=64):
    """csrc/hash_encode.cu's table pass in torch, contribution by
    contribution: each level's positions strided over `blocks` blocks of
    `threads`; in each warp and corner, runs of neighbouring lanes on one
    row summed first; a privatised level summed per block into a copy of
    its lattice whose touched rows are then added to the table, the other
    levels added directly."""
    n = pos.shape[0]
    priv = khash.private_levels(res, dense)
    dt = torch.zeros_like(table2d)
    lane = torch.arange(n)
    block = (lane // threads) % blocks
    for l, r in enumerate(res):
        scaled = pos * r
        base = torch.floor(scaled)
        frac = scaled - base
        base = base.long()
        if dense[l]:
            base = base.clamp(0, r - 1)
        g = cot[:, 2 * l:2 * l + 2]
        copies = {}
        for corner in range(8):
            bits = [(corner >> d) & 1 for d in range(3)]
            c = [base[:, d] + bits[d] for d in range(3)]
            idx = ((c[0] * (r + 1) + c[1]) * (r + 1) + c[2] if dense[l]
                   else thash._hash3(c[0], c[1], c[2], t))
            tw = [frac[:, d] if bits[d] else 1.0 - frac[:, d]
                  for d in range(3)]
            v = (tw[0] * tw[1] * tw[2])[:, None] * g
            for w0 in range(0, n, 32):          # runs within each warp
                rows, vals = idx[w0:w0 + 32].tolist(), v[w0:w0 + 32]
                k = 0
                while k < len(rows):
                    e = k
                    while e + 1 < len(rows) and rows[e + 1] == rows[k]:
                        e += 1
                    s = vals[k:e + 1].sum(0)
                    if l in priv:
                        b = int(block[w0 + k])
                        copies.setdefault(b, torch.zeros(
                            ((r + 1) ** 3, 2)))[rows[k]] += s
                    else:
                        dt[offsets[l] + rows[k]] += s
                    k = e + 1
        for b in sorted(copies):                  # each block's flush
            touched = (copies[b] != 0).any(1)
            rows = torch.nonzero(touched)[:, 0]
            dt[offsets[l] + rows] += copies[b][rows]
    return dt


@pytest.mark.parametrize("layout,hash_mode", [("packed", "auto"),
                                              ("dense", "auto"),
                                              ("packed", "hash")])
def test_table_pass_model_matches_jax(layout, hash_mode):
    """The table pass's accumulation (privatised levels, runs, blocks)
    against the JAX custom VJP's table gradient, within 1e-5 of its
    largest entry; half the positions are samples along rays, so runs of
    one row occur."""
    table = _table(layout, hash_mode, seed=7)
    rng = np.random.default_rng(8)
    pos = _positions(seed=9, n=N)
    start = rng.uniform(0.1, 0.9, (16, 1, 3))
    step = rng.uniform(-0.01, 0.01, (16, 1, 3)) * np.arange(32)[None, :,
                                                                   None]
    pos[N // 2:] = np.clip(start + step, 0, 1).reshape(-1, 3)
    cot = rng.standard_normal((N, 2 * len(RES))).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jhash.hashgrid_encode(t, jnp.asarray(pos),
                                                     RES, hash_mode, T),
                     jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(cot))[0]).reshape(-1, 2)
    table2d, offsets, dense, t = thash._table_layout(
        torch.from_numpy(table), RES, hash_mode, T)
    if hash_mode == "auto":
        assert khash.private_levels(RES, dense) == (0, 1)
    got = _table_pass_model(table2d, torch.from_numpy(pos),
                            torch.from_numpy(cot), RES, offsets, dense, t,
                            blocks=3)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("levels", [1, 3, 4, 5, 8, 9, 12, 16])
def test_level_groups_cover_every_level_once(levels):
    """The forward's level groups: the whole row up to 8 levels (the
    proposal nets' 5 in one group), else groups of 4 (the field's 16 in
    4), each level in exactly one group."""
    group = khash.level_group(levels)
    assert 1 <= group <= khash.MAX_GROUP
    groups = [list(range(l0, min(l0 + group, levels)))
              for l0 in range(0, levels, group)]
    assert [l for g in groups for l in g] == list(range(levels))
    assert len(groups) == (1 if levels <= 8 else -(-levels // 4))


FWD_THREADS = 256     # csrc/hash_encode.cu THREADS: positions a block


def _fwd_store_model(per_level, group):
    """csrc/hash_encode.cu's forward as it stores, in torch: a block of
    FWD_THREADS positions at one group of levels stages its results at
    row stride group | 1 in shared memory, then element q of the block's
    rows × levels goes from stage[(q / nl)·stride + q % nl] to output row
    i0 + q / nl, level l0 + q % nl.  per_level [N, L, 2] → [N, L·2]; every
    output element written exactly once."""
    n, L, _ = per_level.shape
    out = torch.full((n * L, 2), float("nan"))
    written = torch.zeros(n * L, dtype=torch.long)
    sp = group | 1
    for i0 in range(0, n, FWD_THREADS):
        rows = min(FWD_THREADS, n - i0)
        for l0 in range(0, L, group):
            nl = min(group, L - l0)
            stage = torch.full((FWD_THREADS * sp, 2), float("nan"))
            t = torch.arange(rows)[:, None]
            j = torch.arange(nl)[None]
            stage[(t * sp + j).reshape(-1)] = per_level[
                i0:i0 + rows, l0:l0 + nl].reshape(-1, 2)
            q = torch.arange(rows * nl)
            dst = (i0 + q // nl) * L + l0 + q % nl
            out[dst] = stage[(q // nl) * sp + q % nl]
            written[dst] += 1
    assert bool((written == 1).all())
    return out.reshape(n, L * 2)


# the forward's level groups at the presets' level counts: RES's 4 and a
# proposal net's 5 (one group each), the field's 16 (four groups of 4)
STORE_RES = {"4 levels": RES, "5 levels": (4, 6, 8, 12, 16),
             "16 levels": tuple(range(2, 34, 2))}


@pytest.mark.parametrize("levels", list(STORE_RES))
@pytest.mark.parametrize("layout,hash_mode,n", [("packed", "auto", 300),
                                                ("dense", "auto", 261),
                                                ("packed", "hash", 40)])
def test_forward_store_order_keeps_the_plain_layout(layout, hash_mode, n,
                                                    levels):
    """Each level encoded alone by the plain version, put where the
    forward kernel's staging and stores put it at its level groups, gives
    hashgrid_encode_plain's [N, L·2] output bit for bit: level l at
    columns 2l, 2l + 1, a ragged last block included."""
    res = STORE_RES[levels]
    table = torch.from_numpy(_table(layout, hash_mode, res=res))
    pos = torch.from_numpy(_positions(n=n))
    ref = thash.hashgrid_encode_plain(table, pos, res, hash_mode, T)
    if layout == "dense":
        per = [table[l:l + 1] for l in range(len(res))]
    else:
        rows = thash.level_row_counts(res, T, hash_mode)
        offs = np.cumsum((0,) + rows)
        per = [table[offs[l]:offs[l + 1]] for l in range(len(res))]
    per_level = torch.stack([thash.hashgrid_encode_plain(
        per[l], pos, (res[l],), hash_mode, T) for l in range(len(res))], 1)
    got = _fwd_store_model(per_level, khash.level_group(len(res)))
    assert torch.equal(got, ref)


def test_hash_is_uint32_teschner():
    """The int64 hash with 32-bit cuts equals the uint32 product, XOR and
    modulus, wrap-around included."""
    rng = np.random.default_rng(6)
    ijk = rng.integers(-5, 1 << 20, (3, 4096)).astype(np.int32)
    ref = jhash._hash3(*(jnp.asarray(a) for a in ijk), T)
    got = thash._hash3(*(torch.from_numpy(a).long() for a in ijk), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The CUDA wrapper has no CPU path: CPU tensors reach the plain
    version through hashgrid_encode, and the wrapper refuses them."""
    table = torch.from_numpy(_table("packed"))
    pos = torch.from_numpy(_positions(n=64))
    offsets, _ = thash._level_offsets(RES, T, "auto", True)
    dense = tuple(thash.level_uses_dense(r, T) for r in RES)
    with pytest.raises(ValueError, match="CUDA"):
        khash.hash_encode(table, pos, RES, tuple(offsets), dense, T)
    assert khash.hash_encode.launches == 0


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_encoding_matches_jax(levels):
    d = np.random.default_rng(7).standard_normal((257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        torch_sh(torch.from_numpy(d), levels).numpy(),
        np.asarray(jax_sh(jnp.asarray(d), levels)), rtol=1e-6, atol=1e-7)
