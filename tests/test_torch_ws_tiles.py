"""The index math of #1 bf16's warp-specialized body (``csrc/attn_ws.cuh``),
transcribed and held to ``attn_qkv_rel_plain`` on the CPU.

The body reads each query row's rel terms from slot rows that
``fill_slots_rel`` writes, one block per grid row (rel_h against Rh[y]) or
grid column (rel_w against Rw[x]) of a head; it adds them to the scores of a
64-key tile as slot rows · Eᵀ over the slot chunks that tile touches
(``wgmma.cuh``'s ``touched``); it runs a block of 128 query rows as two
64-row warpgroups, of which the second works only with a row below S. The
tests below hold that transcription, on the grids of
``test_torch_tf32x3.py``'s slot test, to the plain version's per-score
lookup bit for bit, and the transcribed tile loop to the plain forward."""

import numpy as np
import pytest
import torch

from beach_seg_tpu_torch.ops import cuda_attn
from beach_seg_tpu_torch.ops.attention import rel_tables_padded

BN = 64  # keys a tile of the body (attn_ws.cuh: one 64-row K, V and E tile a stage)
BQ = 128  # query rows a block, two warpgroups of 64
GRIDS = [(3, 5), (7, 4), (9, 64), (37, 27), (56, 28)]  # ragged; a 64-wide row; crossing chunks; ViT


def round16(x):
    return -(-x // 16) * 16


def touched(c, nx, hkp, c_lo, c_hi):
    """``wgmma.cuh``'s ``touched``: slot chunk c reaches the key tile."""
    return c < nx and (16 * c >= hkp or c_lo <= c <= c_hi)


def tile_chunks(k0, s, wk, hkp, kx):
    """The slot chunks the body's ``issue_s`` multiplies for the key tile at k0."""
    c_lo, c_hi = (k0 // wk) // 16, (min(k0 + BN - 1, s - 1) // wk) // 16
    return [c for c in range(8) if touched(c, kx // 16, hkp, c_lo, c_hi)]


def e_matrix(s, hk, wk):
    """E as ``fill_slots`` writes it: 1 at the key's row kh and at HKP + kw."""
    hkp, kx = round16(hk), round16(hk) + round16(wk)
    e = torch.zeros((s, kx))
    k = torch.arange(s)
    e[k, k // wk] = 1.0
    e[k, hkp + k % wk] = 1.0
    return e


def plain_rel_terms(qkv4, bias, rh_tab, rw_tab, grid, nh):
    """rel_h (B, nH, S, Hk) and rel_w (…, Wk) as ``attn_qkv_rel_plain`` forms
    them: fp32 sums of the biased, unscaled q, rounded to bf16."""
    gh, gw = grid
    b, s, _, c = qkv4.shape
    q5 = (qkv4 + bias)[:, :, 0].reshape(b, gh, gw, nh, c // nh).permute(0, 3, 1, 2, 4).float()
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", q5, rh_tab.float()).bfloat16().float().reshape(b, nh, s, 64)[..., :gh]
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", q5, rw_tab.float()).bfloat16().float().reshape(b, nh, s, 64)[..., :gw]
    return rel_h, rel_w


def prepass_slot_rows(rel_h, rel_w, grid):
    """The slot rows (B, nH, S, KX) as ``fill_slots_rel``'s blocks write them,
    and how often each element is written: block y < Gh writes columns
    [0, HKP) of rows y·Wk + x, x < Wk (rel_h, then zeros); block Gh + x writes
    columns [HKP, KX) of rows y·Wk + x, y < Gh (rel_w, then zeros)."""
    gh, gw = grid
    hkp, kx = round16(gh), round16(gh) + round16(gw)
    b, nh, s, _ = rel_h.shape
    slots = torch.full((b, nh, s, kx), float("nan"))
    writes = torch.zeros((s, kx), dtype=torch.int64)
    for blk in range(gh + gw):
        is_h = blk < gh
        idx = blk if is_h else blk - gh
        rows = [idx * gw + x for x in range(gw)] if is_h else [y * gw + idx for y in range(gh)]
        col0, ncols, terms = (0, hkp, rel_h) if is_h else (hkp, kx - hkp, rel_w)
        vals = torch.nn.functional.pad(terms[:, :, rows], (0, ncols - terms.shape[-1]))
        slots[:, :, rows, col0:col0 + ncols] = vals
        writes[rows, col0:col0 + ncols] += 1
    return slots, writes


def _inputs(grid, nh=2, b=1, seed=7):
    gh, gw = grid
    s, hd = gh * gw, 64
    rng = np.random.default_rng(seed)
    qkv4 = torch.from_numpy(rng.standard_normal((b, s, 3, nh * hd), dtype=np.float32)).bfloat16()
    bias = torch.from_numpy(0.1 * rng.standard_normal((3, nh * hd), dtype=np.float32)).bfloat16()
    rph, rpw = (torch.from_numpy(0.1 * rng.standard_normal((2 * g - 1, hd), dtype=np.float32)) for g in grid)
    rh_tab, rw_tab = (t.bfloat16() for t in rel_tables_padded(rph, rpw, grid, grid))
    return qkv4, bias, rh_tab, rw_tab


@pytest.mark.parametrize("grid", GRIDS)
def test_prepass_slot_rows_and_tile_chunks_equal_the_lookup(grid):
    """Every slot element written once by ``fill_slots_rel``'s blocks, the
    padding zero, and per 64-key tile the slot rows · Eᵀ over the chunks the
    tile touches equal rel_h[r, k / Wk] + rel_w[r, k % Wk] exactly in fp32."""
    gh, gw = grid
    s = gh * gw
    qkv4, bias, rh_tab, rw_tab = _inputs(grid)
    rel_h, rel_w = plain_rel_terms(qkv4, bias, rh_tab, rw_tab, grid, 2)
    slots, writes = prepass_slot_rows(rel_h, rel_w, grid)
    hkp, kx = round16(gh), round16(gh) + round16(gw)
    assert torch.equal(writes, torch.ones_like(writes))
    assert slots[..., gh:hkp].abs().sum() == 0 and slots[..., hkp + gw:].abs().sum() == 0
    e = e_matrix(s, gh, gw)
    kidx = torch.arange(s)
    lookup = rel_h[..., kidx // gw] + rel_w[..., kidx % gw]
    for k0 in range(0, s, BN):
        keys = slice(k0, min(k0 + BN, s))
        got = torch.zeros_like(lookup[..., keys])
        for c in tile_chunks(k0, s, gw, hkp, kx):
            got = got + slots[..., 16 * c:16 * c + 16] @ e[keys, 16 * c:16 * c + 16].T
        assert torch.equal(got, lookup[..., keys]), (grid, k0)


@pytest.mark.parametrize("grid", GRIDS + [(14, 14)])
def test_blocks_cover_every_row_once(grid):
    """The blocks of 128 rows and their working warpgroups (the second works
    only with a row below S) cover rows [0, S) once; an idle warpgroup has
    no row below S; the key tiles cover [0, S) and the last one's keys past
    S are the ones the tail mask drops."""
    s = grid[0] * grid[1]
    covered = torch.zeros(s, dtype=torch.int64)
    for q0 in range(0, s, BQ):
        nwg = 2 if q0 + 64 < s else 1
        for w in range(2):
            rows = torch.arange(q0 + 64 * w, q0 + 64 * w + 64)
            if w < nwg:
                covered[rows[rows < s]] += 1
            else:
                assert rows.min() >= s
    assert torch.equal(covered, torch.ones_like(covered))
    nk = -(-s // BN)
    assert nk * BN >= s > (nk - 1) * BN


def ws_forward_emulated(qkv4, bias, rh_tab, rw_tab, scale, grid, nh, softmax):
    """The body's arithmetic in fp32 on the CPU: q·scale and k, v with their
    biases rounded as the kernel rounds them, 64-key tiles of slot rows · E
    over the touched chunks added to Q·Kᵀ, the tail mask, the online
    softmax (stable: row max and rescale of O; clamp / fast: none), p
    rounded to bf16 before PV, division after PV."""
    gh, gw = grid
    b, s, _, c = qkv4.shape
    hd = c // nh
    hkp, kx = round16(gh), round16(gh) + round16(gw)
    x = qkv4 + bias
    q, k, v = (x[:, :, i].reshape(b, s, nh, hd).transpose(1, 2) for i in range(3))
    qs = (q * torch.tensor(scale, dtype=torch.bfloat16)).float()
    slots, _ = prepass_slot_rows(*plain_rel_terms(qkv4, bias, rh_tab, rw_tab, grid, nh), grid)
    e = e_matrix(s, gh, gw)
    m = torch.full((b, nh, s, 1), -float("inf"))
    l = torch.zeros((b, nh, s, 1))
    o = torch.zeros((b, nh, s, hd))
    for k0 in range(0, s, BN):
        keys = slice(k0, min(k0 + BN, s))
        sc = qs @ k[:, :, keys].float().transpose(-1, -2)
        for ch in tile_chunks(k0, s, gw, hkp, kx):
            sc = sc + slots[..., 16 * ch:16 * ch + 16] @ e[keys, 16 * ch:16 * ch + 16].T
        alpha = torch.ones_like(m)
        if softmax == "stable":
            mnew = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha, m = torch.exp(m - mnew), mnew
            p = torch.exp(sc - m)
        else:
            p = torch.exp(torch.clamp(sc, max=80.0) if softmax == "clamp" else sc)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ v[:, :, keys].float()
    out = o / (l + (0.0 if softmax == "stable" else 1e-30))
    return out.bfloat16().transpose(1, 2).reshape(b, s, c)


@pytest.mark.parametrize("softmax", cuda_attn.SOFTMAX_MODES)
@pytest.mark.parametrize("grid", [(7, 4), (37, 27)])
def test_tile_loop_emulation_matches_plain(grid, softmax):
    """The transcribed tile loop against ``attn_qkv_rel_plain`` within the
    card tests' bf16 limits (the sums run in another order)."""
    qkv4, bias, rh_tab, rw_tab = _inputs(grid, nh=2, b=1, seed=3)
    got = ws_forward_emulated(qkv4, bias, rh_tab, rw_tab, 0.125, grid, 2, softmax).float()
    want = cuda_attn.attn_qkv_rel_plain(qkv4, bias, rh_tab, rw_tab, 0.125, grid[1], 2, softmax).float()
    d = got - want
    assert d.abs().max().item() <= min(3e-2, 4 * 2.0**-8 * want.abs().max().item())
    assert (d.norm() / want.norm()).item() <= 2.0**-8


@pytest.mark.parametrize("grid,heads", [((56, 28), 16), ((37, 27), 3), ((9, 64), 3), ((14, 14), 16), ((13, 15), 8),
                                        ((7, 4), 3), ((3, 5), 3)])
def test_ws_scratch_covers_the_tensor_maps(grid, heads):
    """#1 bf16's scratch (``cuda_attn._ws_scratch``) holds what
    ``attn_ws.cuh``'s launch encodes its tensor maps over and its pre-pass
    writes: E (S rounded up to 64 rows, KX), the slot rows (B·H·S, KX) and
    the biased k and v (2, B·H, S, 64), all bf16; and every 64-key tile the
    producer loads starts inside E."""
    b, (gh, gw) = 2, grid
    s, kx = gh * gw, round16(gh) + round16(gw)
    e, slots, kv = cuda_attn._ws_scratch(b, heads, s, gh, gw, "cpu")
    assert all(x.dtype == torch.bfloat16 and x.is_contiguous() for x in (e, slots, kv))
    assert tuple(e.shape) == (-(-s // BN) * BN, kx)  # edims: (KX, s_pad)
    assert tuple(slots.shape) == (b * heads * s, kx)  # rdims: (KX, S, B·H)
    assert tuple(kv.shape) == (2, b * heads, s, 64)  # kdims: (64, S, 2·B·H)
    nk = -(-s // BN)
    assert all(BN * i + BN <= e.shape[0] for i in range(nk))
