"""The port's int4 dequant-matmul (roboticattack_torch/ops/q4_matmul.py)
against the JAX package's Pallas kernel (run in interpret mode, as its own
tests run it on the CPU) and its f32 reference dequant.

On the CPU the wrapper computes the plain version; the CUDA kernel itself is
held against the plain version on the card by test_torch_q4_matmul_cuda.py
(and by chip_smoke.py)."""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.ops.q4_matmul import q4_matmul as jax_q4_matmul
from roboticattack_tpu.ops.q4_matmul import q4_reference
from roboticattack_torch.ops import kernel_build
from roboticattack_torch.ops.q4_matmul import (
    KERNEL_GROUP_SIZES,
    _unpack_nibbles,
    entry_for,
    q4_matmul,
    q4_matmul_plain,
    reset_launches,
)

SHAPES = [
    (256, 512, 1, 1),     # matvec
    (256, 512, 3, 7),     # Jacobi-pass shape, m=21
    (384, 768, 2, 1),     # out not a multiple of the JAX tile (256)
]


def _mk(out_dim, in_dim, gs, b, s, seed=0):
    """Random packed s4 bytes, positive group scales, activations (numpy)."""
    rng = np.random.default_rng(seed)
    g = in_dim // gs
    w = rng.integers(-128, 128, size=(out_dim, in_dim // 2), dtype=np.int64).astype(np.int8)
    scale = (rng.standard_normal((out_dim, g)).astype(np.float32) * 0.02) ** 2 + 1e-4
    y = rng.standard_normal((b, s, in_dim)).astype(np.float32)
    return y, w, scale


@pytest.mark.parametrize("mode", ["grouped", "dense"])
@pytest.mark.parametrize("out_dim,in_dim,b,s", SHAPES)
def test_plain_f32_matches_jax_interpret(mode, out_dim, in_dim, b, s):
    """op_dtype=float32 is the JAX kernel's interpret-mode arithmetic: f32
    activations, f32 contraction. Tolerance: both sum in f32, in different
    orders (per-group partials vs the interpreter's sequential group loop),
    so they agree to a few f32 ulps of the output's magnitude."""
    y, w, scale = _mk(out_dim, in_dim, gs=128, b=b, s=s)
    want = np.asarray(jax_q4_matmul(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(scale), tile_o=256,
        mode=mode, interpret=True,
    ))
    got = q4_matmul_plain(
        torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(scale),
        mode, torch.float32,
    ).numpy()
    assert got.shape == (b, s, out_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["grouped", "dense"])
@pytest.mark.parametrize("out_dim,in_dim,b,s", SHAPES)
def test_plain_bf16_matches_reference(mode, out_dim, in_dim, b, s):
    """op_dtype=bfloat16 is the kernel's compiled semantics (bf16
    activations; dense rounds the dequantized weights to bf16) and returns
    bf16. Against the f32 reference dequant the error is bf16 rounding:
    the JAX package's own kernel test bound (rtol 2e-2, atol 2e-2 * max)."""
    y, w, scale = _mk(out_dim, in_dim, gs=128, b=b, s=s)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    want = np.asarray(q4_reference(
        jnp.asarray(yb.float().numpy()), jnp.asarray(w), jnp.asarray(scale)
    ))
    got = q4_matmul_plain(
        yb, torch.from_numpy(w), torch.from_numpy(scale), mode, torch.bfloat16
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max()
    )


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    """A CPU tensor takes the plain f32 version and launches nothing."""
    reset_launches()
    y, w, scale = (torch.from_numpy(a) for a in _mk(256, 512, 128, 2, 1, seed=3))
    for mode in ("grouped", "dense"):
        got = q4_matmul(y, w, scale, mode=mode)
        torch.testing.assert_close(got, q4_matmul_plain(y, w, scale, mode, torch.float32),
                                   rtol=0, atol=0)
    assert q4_matmul.launches == {"grouped": 0, "dense": 0}


def test_wrapper_rejects_bad_shapes_and_modes():
    y, w, scale = (torch.from_numpy(a) for a in _mk(256, 512, 128, 1, 1))
    with pytest.raises(ValueError, match="packed width"):
        q4_matmul(y[..., :-2], w, scale)
    with pytest.raises(ValueError, match="groups"):
        q4_matmul(y, w, scale[:, :3])
    with pytest.raises(ValueError, match="mode"):
        q4_matmul(y, w, scale, mode="fused")


@pytest.mark.parametrize("mode,in_dim,groups,entry", [
    ("grouped", 4096, 32, "q4_matmul_grouped_mma_bf16"),    # the 7B: groups of 128
    ("grouped", 11008, 86, "q4_matmul_grouped_mma_bf16"),
    ("grouped", 1024, 4, "q4_matmul_grouped_mma_bf16"),     # groups of 256
    ("grouped", 2048, 2, "q4_matmul_grouped_mma_bf16"),     # groups of 1024
    ("grouped", 512, 8, "q4_matmul_grouped_mma_bf16"),      # groups of 64
    ("grouped", 512, 16, "q4_matmul_grouped_mma_bf16"),     # groups of 32
    ("dense", 4096, 32, "q4_matmul_dense_mma_bf16"),
    ("dense", 512, 8, "q4_matmul_dense_mma_bf16"),          # groups of 64
    ("dense", 512, 16, "q4_matmul_dense_mma_bf16"),         # groups of 32
])
def test_body_for_routes_by_shape(mode, in_dim, groups, entry):
    """Every group the wrapper takes, in both modes, launches the one
    tensor-core body through its mode's entry (`entry_for`; grouped groups
    of 32/64 no longer take a body of their own); other group sizes raise."""
    assert entry_for(mode, in_dim, groups) == entry
    with pytest.raises(ValueError, match="group size"):
        entry_for(mode, 96 * groups, groups)  # groups of 96 channels


# The fragment maps of csrc/q4_matmul.cu: the lane's piece of a row is 16 >>
# piece_log2 bytes of each of the k-block's 1 << piece_log2 groups (0: groups
# of >= 128 channels and dense mode, 1: groups of 64, 2: groups of 32).
PIECE_LOG2 = {128: 0, 64: 1, 32: 2}


def _fragment_map(b, piece_log2=0, byte_pairs=False):
    """The tensor-core body's index map for k-block b, as the header of
    csrc/q4_matmul.cu states it. mma.sync m16n8k16 gives lane (g, t) the A
    registers (row g or g+8; logical k 2t, 2t+1 | 2t+8, 2t+9) and the B
    registers (column g; the same k). Lane (g, t) holds 4 words of rows g and
    g+8: word q = p * W + qq (W = 4 >> piece_log2 words a piece) starts at
    byte 64b + (64 >> piece_log2) * p + (16 >> piece_log2) * t + 4 * qq. In
    mma s (q = s // 2, e = s % 2) logical k = 2t + 8 * half + nib takes
    channel 2 * (the word's first byte) + 2e + half + 4 * nib: the A register
    is one lop3 of word q (nibbles 2e + half and 2e + half + 4), the B
    register a prmt of the activations. With `byte_pairs` (m > 8) the A
    register is the two nibbles of one byte: k = 2t + 8 * half + nib takes
    channel 2 * (the word's first byte) + 4e + 2 * half + nib, so the B
    registers are activation words as they are. Returns, for each s and
    logical k (0..15), the packed byte and nibble A takes and the
    activation channel B takes: [8, 16] each."""
    k = torch.arange(16)
    t, half, nib = (k % 8) // 2, k // 8, k % 2
    s = torch.arange(8)[:, None]
    q, e = s // 2, s % 2
    words = 4 >> piece_log2
    byte0 = 64 * b + (64 >> piece_log2) * (q // words) + (16 >> piece_log2) * t + 4 * (q % words)
    if byte_pairs:
        a_byte = byte0 + 2 * e + half
        a_nib = nib.expand(8, 16)
        b_chan = 2 * byte0 + 4 * e + 2 * half + nib
    else:
        a_byte = byte0 + e + 2 * nib
        a_nib = half.expand(8, 16)
        b_chan = 2 * byte0 + 2 * e + half + 4 * nib
    return a_byte, a_nib, b_chan


def _act_index(q, t, piece_log2):
    """The kernel's `act_index`: which of the k-block's 16 loads of 8
    activation channels pairs with word q of lane t."""
    words = 4 >> piece_log2
    return (16 >> piece_log2) * (q // words) + words * t + q % words


@pytest.mark.parametrize("byte_pairs", [False, True])
@pytest.mark.parametrize("piece_log2", [0, 1, 2])
@pytest.mark.parametrize("b", [0, 3])
def test_fragment_map_visits_each_channel_once(b, piece_log2, byte_pairs):
    """(a) Over one k-block, A and B take each of its 128 channels exactly
    once, and in every mma slot both take the same channel, at every map
    and both pairings."""
    a_byte, a_nib, b_chan = _fragment_map(b, piece_log2, byte_pairs)
    a_chan = 2 * a_byte + a_nib
    assert torch.equal(a_chan, b_chan)
    want = torch.arange(128 * b, 128 * (b + 1))
    assert torch.equal(a_chan.flatten().sort().values, want)
    assert torch.equal(b_chan.flatten().sort().values, want)
    # lane t's 8 mma's take both nibbles of its 16 bytes of each row, in
    # pieces of 16 >> piece_log2 contiguous bytes, one in each of the
    # k-block's groups; word q's activations are the 8 channels of load
    # act_index(q, t)
    size = 16 >> piece_log2
    for t in range(4):
        ks = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
        pieces = torch.cat([torch.arange(64 * b + 4 * size * p + size * t, 64 * b + 4 * size * p + size * (t + 1))
                            for p in range(1 << piece_log2)])
        assert torch.equal(a_byte[:, ks].flatten().sort().values, pieces.repeat_interleave(2))
        for q in range(4):
            chans = b_chan[2 * q:2 * q + 2][:, ks].flatten().sort().values
            idx = 16 * b + _act_index(q, t, piece_log2)
            assert torch.equal(chans, torch.arange(8 * idx, 8 * idx + 8))


@pytest.mark.parametrize("byte_pairs", [False, True])
@pytest.mark.parametrize("gs", [32, 64, 128, 256])
def test_every_mma_takes_one_group(gs, byte_pairs):
    """(b) With the map of its group size, each mma slot's 16 channels lie
    in one group, and the groups end at slot boundaries: after every gs / 16
    slots of the kernel's order (k-blocks in turn, slots 0..7)."""
    piece_log2 = PIECE_LOG2[min(gs, 128)]
    order = torch.cat([_fragment_map(b, piece_log2, byte_pairs)[2] for b in range(4)])  # [32 slots, 16]
    grp = order // gs
    assert all(len(set(grp[s].tolist())) == 1 for s in range(32))
    assert torch.equal(grp[:, 0], torch.arange(32) // (gs // 16))


def _chunk_off(r, c, piece_log2):
    """The kernel's `chunk_off<piece_log2>`: the byte offset of 16-byte chunk
    c of row r in a stage (128 bytes a row), the chunk index XORed with 4 (r
    & 1), then r & 2 (8-byte pieces), then (r >> 2) & 1 (4-byte pieces)."""
    f = ((r & 1) << 2) | ((r & 2) if piece_log2 > 0 else 0) | (((r >> 2) & 1) if piece_log2 > 1 else 0)
    return r * 128 + ((c ^ f) << 4)


@pytest.mark.parametrize("piece_log2", [0, 1, 2])
def test_stage_reads_are_free_of_bank_conflicts(piece_log2):
    """(c) The lanes' reads of their pieces from a stage, as the kernel makes
    them (`lane_words`: one 16-byte, two 8-byte or four 4-byte loads a row
    tile's row g or g+8 and k-block h), touch 32 distinct banks in each
    phase of the load (quarter warps for 16 bytes, half warps for 8, the
    warp for 4)."""
    size = 16 >> piece_log2
    lanes_a_phase = {16: 8, 8: 16, 4: 32}[size]
    for row_base in (0, 8, 16, 24):   # rows g, g+8 of row tiles 0 and 1
        for h in range(2):
            for p in range(1 << piece_log2):
                addrs = []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    byte = 64 * h + 4 * size * p + size * t   # the piece's first byte in the stage row
                    addrs.append(_chunk_off(row_base + g, byte // 16, piece_log2) + byte % 16)
                for ph in range(0, 32, lanes_a_phase):
                    banks = [(a // 4 + i) % 32 for a in addrs[ph:ph + lanes_a_phase] for i in range(size // 4)]
                    assert len(set(banks)) == len(banks) == 32, (row_base, h, p, ph)


def _act_pos(R, c, piece_log2):
    """The kernel's `act_pos<piece_log2>`: where 16-byte chunk c (0..15) of
    activation row R of a k-block sits among the row's 16 in a stage at m >
    8."""
    s = (((R & 1) << 1) | (c >> 3)) if piece_log2 == 0 else (R & 1) << (0 if piece_log2 == 1 else 2)
    return ((c & 7) ^ s) | (c & 8)


@pytest.mark.parametrize("piece_log2", [0, 1, 2])
def test_activation_stage_is_a_permutation_free_of_bank_conflicts(piece_log2):
    """(c') At m > 8 the activations of a k-block sit in shared memory 256
    bytes a row, chunk c of row R at `act_pos`: a permutation of each row's
    16 chunks, and the lanes' 16-byte reads of one word q of n-tile nt (row
    8nt + g, chunk act_index(q, t)) fall in 8 distinct 16-byte bank groups
    in each quarter-warp phase (lanes 8i..8i+7: rows g = 2i, 2i+1)."""
    for R in range(4):
        assert sorted(_act_pos(R, c, piece_log2) for c in range(16)) == list(range(16))
    for nt in range(2):
        for q in range(4):
            for ph in range(0, 32, 8):
                groups = {}
                for lane in range(ph, ph + 8):
                    g, t = lane // 4, lane % 4
                    R = 8 * nt + g
                    pos = R * 16 + _act_pos(R, _act_index(q, t, piece_log2), piece_log2)
                    groups[lane] = pos % 8
                assert len(set(groups.values())) == 8, (nt, q, ph, groups)


def _mma_order_matmul(y, w, scale, piece_log2=0, flush_slots=None, byte_pairs=False):
    """The tensor-core body's grouped arithmetic in plain torch: per k-block
    b, 8 f32 mma products through the fragment map of `piece_log2` (and
    pairing `byte_pairs`), into a
    partial that is scaled and added to the accumulator after every
    `flush_slots` mma's (by default a group's, gs / 16), by the scale of the
    group of the first of them. Channels past the contraction's end (a
    partial last k-block) contribute nothing. y [m, in] f32, result
    [m, out]."""
    lo, hi = _unpack_nibbles(w)
    out_dim, in_half = w.shape
    in_dim = 2 * in_half
    gs = in_dim // scale.shape[1]
    flush_slots = flush_slots or gs // 16
    acc = torch.zeros(y.shape[0], out_dim)
    part = torch.zeros_like(acc)
    n = first = 0
    for b in range(-(-in_dim // 128)):
        a_byte, a_nib, b_chan = _fragment_map(b, piece_log2, byte_pairs)
        for s in range(8):
            live = b_chan[s] < in_dim
            byte = a_byte[s].clamp(max=in_half - 1)
            a = torch.where(a_nib[s] == 0, lo[:, byte], hi[:, byte]).float() * live  # [out, 16]
            if n == 0:
                first = int(b_chan[s].min())
            part += (y[:, b_chan[s].clamp(max=in_dim - 1)] * live) @ a.T
            n += 1
            if n == flush_slots:
                acc += part * scale[:, min(first // gs, scale.shape[1] - 1)]
                part.zero_()
                n = 0
    return acc


@pytest.mark.parametrize("out_dim,in_dim,gs,m", [
    (256, 512, 128, 8), (384, 1024, 256, 3),
    (64, 512, 64, 8), (64, 512, 32, 5),
    (48, 320, 64, 3),    # a partial last k-block (in % 128 == 64): 2.5 k-blocks
    (48, 352, 32, 4),    # in % 128 == 96
    (32, 2752, 64, 2),   # the contraction of a tp=4 rank's down_w: 21.5 k-blocks
])
def test_fragment_order_matches_plain(out_dim, in_dim, gs, m):
    """(d) Summing the products in the kernel's order, through the map of
    the group size (both pairings: m <= 8 and m > 8), with f32 partials
    scaled per group, is the plain version's function: both sum exact
    products in f32, in different orders (1e-5 relative)."""
    y, w, scale = _mk(out_dim, in_dim, gs, m, 1, seed=7)
    yt = torch.from_numpy(y).to(torch.bfloat16).float()[:, 0]
    wt, st = torch.from_numpy(w), torch.from_numpy(scale)
    want = q4_matmul_plain(yt[:, None], wt, st, "grouped", torch.float32)[:, 0]
    for byte_pairs in (False, True):
        got = _mma_order_matmul(yt, wt, st, PIECE_LOG2[min(gs, 128)], byte_pairs=byte_pairs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_groups_of_64_cannot_flush_at_a_kblock_boundary():
    """Why groups of 32/64 take a fragment map of their own: with the
    16-byte map (still the map of groups of >= 128 and of dense mode) every
    mma of a k-block mixes channels of two 64-channel groups, so no partial
    belongs to one group, and scaling a k-block's partial by one scale is a
    different function. With the 8-byte map each mma stays in one group, and
    flushing after mma's 3 and 7 is the plain version's function."""
    for b in range(2):
        _, _, b_chan = _fragment_map(b)
        assert all(len(set((b_chan[s] // 64).tolist())) == 2 for s in range(8))
        assert all(len(set((b_chan[s] // 128).tolist())) == 1 for s in range(8))
        _, _, b_chan = _fragment_map(b, PIECE_LOG2[64])
        assert all(len(set((b_chan[s] // 64).tolist())) == 1 for s in range(8))
    y, w, scale = _mk(64, 512, 64, 4, 1, seed=8)
    yt = torch.from_numpy(y).to(torch.bfloat16).float()[:, 0]
    wt, st = torch.from_numpy(w), torch.from_numpy(scale)
    want = q4_matmul_plain(yt[:, None], wt, st, "grouped", torch.float32)[:, 0]
    # the 16-byte map: one scale for each pair of 64-channel groups, flushed per k-block
    got = _mma_order_matmul(yt, wt, st[:, 0::2].contiguous(), flush_slots=8)
    err = (got - want).abs().max().item()
    assert err > 1e-2 * want.abs().max().item(), err
    # the 8-byte map, flushed per group
    got = _mma_order_matmul(yt, wt, st, PIECE_LOG2[64])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_offset_binary_unpack_is_exact():
    """The tensor-core body's unpacking, on 32-bit words of packed bytes:
    ((w >> 4j) & 0x000F000F) ^ 0x43084308 is the bf16 pair 128 + (u ^ 8) of
    nibbles j and j+4; less 136 each is the signed nibble, exactly, for all
    256 byte values."""
    packed = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # 64 words, little-endian
    lo, hi = _unpack_nibbles(packed[None])
    nibbles = torch.stack([lo[0], hi[0]], dim=-1).reshape(64, 8).float()  # nibble i of each word
    k136 = torch.tensor(136.0, dtype=torch.bfloat16)
    for j in range(4):
        v = ((words >> (4 * j)) & 0x000F000F) ^ 0x43084308
        pair = v.to(torch.int32).view(torch.int16).view(torch.bfloat16).reshape(64, 2) - k136
        assert torch.equal(pair.float(), nibbles[:, [j, j + 4]])


def test_byte_pair_unpack_is_exact():
    """The m > 8 unpacking (`s4_byte_pair<j>`), on 32-bit words of packed
    bytes: prmt(w, w >> 4) takes byte j of each into bytes 0 and 2, then
    (& 0x000F000F) ^ 0x43084308 less 136 each is the bf16 pair (low nibble,
    high nibble) of byte j, exactly, for all 256 byte values."""
    packed = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # 64 words, little-endian
    lo, hi = _unpack_nibbles(packed[None])
    pairs = torch.stack([lo[0], hi[0]], dim=-1).reshape(64, 4, 2).float()  # byte j's (lo, hi)
    k136 = torch.tensor(136.0, dtype=torch.bfloat16)
    w4 = words >> 4
    for j in range(4):
        x = ((words >> (8 * j)) & 0xFF) | (((w4 >> (8 * j)) & 0xFF) << 16)  # bytes 0 and 2 of the prmt
        v = (x & 0x000F000F) ^ 0x43084308
        pair = v.to(torch.int32).view(torch.int16).view(torch.bfloat16).reshape(64, 2) - k136
        assert torch.equal(pair.float(), pairs[:, j])


def _dense_a_pair(words, j, scale):
    """The dense body's A register (`a_pair<4j, true>`), on 32-bit words of
    packed bytes: the s4 pair of nibbles j, j+4 as bf16 (as the unpack
    above), widened to two f32 by bit placement (low half << 16, high half
    masked), each multiplied by the f32 scale, rounded to bf16 (nearest
    even, as cvt.rn.bf16x2.f32). words [n] int64, scale [k] f32 ->
    [n, 2, k] bf16 (nibble j, nibble j+4)."""
    k136 = torch.tensor(136.0, dtype=torch.bfloat16)
    v = ((words >> (4 * j)) & 0x000F000F) ^ 0x43084308
    pair = (v.to(torch.int32).view(torch.int16).view(torch.bfloat16).reshape(-1, 2) - k136)
    p = pair.view(torch.int32)[:, 0].to(torch.int64) & 0xFFFFFFFF  # the 32-bit register
    lo = ((p << 16) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    hi = (p & 0xFFFF0000).to(torch.int32).view(torch.float32)
    return (torch.stack([lo, hi], dim=-1)[..., None] * scale).to(torch.bfloat16)


def test_dense_dequant_is_the_plain_versions_bits():
    """(a) The dense body's dequant, over all 16 nibbles (all 256 bytes) and
    4096 f32 scales from 1e-42 (subnormal products) to 1e38 (products that
    overflow to inf), both signs: bit for bit the plain version's
    bf16(f32(n) * s). The f32 multiply rounds once and the conversion once,
    as in `q4_matmul_plain`."""
    rng = np.random.default_rng(11)
    mag = 10.0 ** rng.uniform(-42, 38, size=4096)
    scale = torch.from_numpy((mag * rng.choice([-1.0, 1.0], size=4096)).astype(np.float32))
    assert (scale.abs() < 1e-38).any() and (scale.abs() > 1e37).any()
    packed = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lo, hi = _unpack_nibbles(packed[None])
    nibbles = torch.stack([lo[0], hi[0]], dim=-1).reshape(64, 8).float()
    for j in range(4):
        got = _dense_a_pair(words, j, scale)
        want = (nibbles[:, [j, j + 4], None] * scale).to(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), j


def _mma_order_dense(y, w, scale):
    """The dense body's arithmetic in plain torch: per k-block b, 8 f32 mma
    products through the fragment map into one accumulator (no per-group
    partial), each A element dequantized with its lane's scale
    scale[:, (128b + 32t) // gs], as `_dense_a_pair` does; channels past the
    contraction's end (a partial last k-block) contribute nothing. y [m, in]
    f32, result [m, out] f32."""
    lo, hi = _unpack_nibbles(w)
    out_dim, in_half = w.shape
    in_dim = 2 * in_half
    gs = in_dim // scale.shape[1]
    acc = torch.zeros(y.shape[0], out_dim)
    t = (torch.arange(16) % 8) // 2  # the lane (g, t) that holds logical k
    for b in range(-(-in_dim // 128)):
        a_byte, a_nib, b_chan = _fragment_map(b)
        for s in range(8):
            live = b_chan[s] < in_dim
            byte = a_byte[s].clamp(max=in_half - 1)
            n = torch.where(a_nib[s] == 0, lo[:, byte], hi[:, byte]).float()  # [out, 16]
            sc = scale[:, ((128 * b + 32 * t) // gs).clamp(max=scale.shape[1] - 1)]
            a = (n * sc).to(torch.bfloat16).float() * live
            acc += y[:, b_chan[s].clamp(max=in_dim - 1)] * live @ a.T
    return acc


@pytest.mark.parametrize("out_dim,in_dim,gs,m", [
    (64, 512, 32, 8), (64, 512, 64, 3), (96, 512, 128, 8), (64, 1024, 256, 5),
    (48, 384, 32, 4),   # an odd count of k-blocks
    (48, 352, 32, 2),   # a partial last k-block (in % 128 == 96)
    (48, 320, 64, 3),   # a partial last k-block (in % 128 == 64)
])
def test_dense_fragment_order_matches_plain(out_dim, in_dim, gs, m):
    """(b) Dequantizing through the fragment map with each lane's group
    scale and summing in the kernel's order is the plain version's dense
    function (weights rounded to bf16, one f32 contraction): both sum exact
    products in f32, in different orders (1e-5 relative)."""
    y, w, scale = _mk(out_dim, in_dim, gs, m, 1, seed=9)
    yt = torch.from_numpy(y).to(torch.bfloat16).float()[:, 0]
    wt, st = torch.from_numpy(w), torch.from_numpy(scale)
    got = _mma_order_dense(yt, wt, st)
    want = q4_matmul_plain(yt[:, None], wt, st, "dense", torch.bfloat16)[:, 0]
    assert want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("mode", ["grouped", "dense"])
def test_sweep_variants_still_match_the_cuda_source(mode):
    """Every variant of scripts/sweep_q4_mma.py is a text edit of
    csrc/q4_matmul.cu: each edit must still find its text there, and change
    the source."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "sweep_q4_mma.py"
    spec = importlib.util.spec_from_file_location("sweep_q4_mma", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = (kernel_build.CSRC / "q4_matmul.cu").read_text()
    texts = sweep.variant_sources(mode, src)
    assert texts.pop("as is") == src
    assert texts and all(t != src for t in texts.values())


def test_kernel_group_sizes_are_32_times_a_power_of_two():
    """The one definition of the groups the CUDA kernel takes (the wrapper
    and VLAPolicy both read it): 1 to 32 lanes of 32 channels."""
    assert KERNEL_GROUP_SIZES == (32, 64, 128, 256, 512, 1024)
