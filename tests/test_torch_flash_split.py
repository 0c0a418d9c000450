"""How K3/K4 split their work, held on the CPU.

- ``decode_split`` (the wrapper's rule for the sequence split) for every
  chunk count it returns: every position of ``[0, n_pos)`` falls in
  exactly one split, no split lies wholly past ``n_pos``, chunks are
  multiples of the warp tile, and the generates' short slot caches
  (``n_pos`` <= 128) take one split, so no combine launch.
- ``row_groups``: at most 8 query rows a group, every row in one group.
- ``blocks_per_sm`` over every head dim, both kernels and every group
  size (two blocks an SM up to head_dim 128; one at 256, where a block's
  rings fill an SM's shared memory, but for K4 at 8 rows) and its
  refusal of any other head dim; ``decode_split`` at one block an SM
  over the same positions and block counts, and the split + combine at
  Gemma-2's head_dim against the plain version and the JAX package.
- A plain torch model of the kernel's split + combine (in this file: per
  split the running max, sum and numerator over the split's positions,
  then the splits folded in order, skipping those with sum 0), on the
  rule's chunks, against ``decode_attention_plain`` and the JAX package's
  Pallas kernels run with ``interpret=True``. Tolerance: 1e-5 * max|out|
  (fp32 throughout; the sides differ in summation order only). Cases:
  bf16 and int8, slot and paged, ``q_span`` 1 and 8 (32 query rows in
  four groups), window and softcap, a row of length 1 and a window that
  leaves the leading splits empty; a row that sees nothing gives zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.ops import attention as ja
from quantizations_tpu.ops import paged_attention as jpa
from quantizations_tpu_torch.ops import attention as ta
from quantizations_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

TOL = 1e-5
NEG = -1e30
KVH, G, D = 2, 4, 32
BLOCKS = (1, 2, 4, 8, 16, 24, 32, 64, 96, 128, 264, 512)


def _t(a):
    """numpy or JAX (incl. bfloat16) -> torch, by bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, ref):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _covers_every_position_once(blocks, per_sm):
    target = ta.SPLIT_SMS * per_sm
    seen = set()
    for n_pos in range(1, 4097):
        n_split, chunk = ta.decode_split(n_pos, blocks, per_sm)
        seen.add(n_split)
        assert chunk % ta.SPLIT_TILE == 0 and chunk % ta.SPLIT_ALIGN == 0
        assert chunk >= ta.SPLIT_MIN_CHUNK
        # every position in exactly one split, no split past the end
        assert (n_split - 1) * chunk < n_pos <= n_split * chunk
        owner = np.arange(n_pos) // chunk
        assert owner.min() == 0 and owner.max() == n_split - 1
        assert np.bincount(owner, minlength=n_split).min() >= 1
        if n_pos <= ta.SPLIT_MIN_CHUNK:
            assert n_split == 1
        # a split grid stays within the target, and the chunk is the
        # smallest that does so
        want = max(1, target // blocks)
        assert n_split <= want
        assert n_split == 1 or n_split * blocks <= target
        if chunk > ta.SPLIT_MIN_CHUNK:
            assert -(-n_pos // (chunk - ta.SPLIT_ALIGN)) > want
    assert 1 in seen
    if 2 * blocks <= target:
        assert max(seen) > 1


@pytest.mark.parametrize("blocks", BLOCKS)
def test_split_rule_covers_every_position_once(blocks):
    _covers_every_position_once(blocks, 2)


@pytest.mark.parametrize("n_pos", [1, 17, 60, 75, 76, 128])
def test_generates_take_one_split(n_pos):
    """The generates' slot caches (prompt + new tokens <= 76) launch no
    combine, at any batch."""
    for blocks in BLOCKS:
        for per_sm in (1, 2):
            assert ta.decode_split(n_pos, blocks, per_sm) == (
                1, ta.SPLIT_MIN_CHUNK)


def test_split_rule_at_the_main_path():
    """Llama3-8B's 8 kv heads, 4 query rows: the pool of 2048 positions
    and a slot cache of 1900 split at B <= 8, more at a smaller batch."""
    for int8 in (False, True):
        assert ta.blocks_per_sm(128, int8, 4) == 2
    for B in (1, 4, 8):
        n, chunk = ta.decode_split(2048, B * 8, 2)
        assert n > 1 and 128 <= n * B * 8 <= 2 * ta.SPLIT_SMS
    assert ta.decode_split(2048, 8, 2) == (16, 128)
    assert ta.decode_split(2048, 32, 2) == (8, 256)
    assert ta.decode_split(2048, 64, 2) == (4, 512)
    with pytest.raises(ValueError):
        ta.decode_split(0, 8, 2)
    with pytest.raises(ValueError):
        ta.decode_split(2048, 8, 0)


@pytest.mark.parametrize("qg", range(1, 33))
def test_row_groups(qg):
    n, rows = ta.row_groups(qg)
    assert 1 <= rows <= ta.GROUP_ROWS and n == -(-qg // ta.GROUP_ROWS)
    groups = [range(g * rows, min(qg, (g + 1) * rows)) for g in range(n)]
    assert [r for g in groups for r in g] == list(range(qg))
    assert all(len(g) >= 1 for g in groups)


@pytest.mark.parametrize("head_dim", [16, 32, 63, 64, 96, 127, 128, 192, 255,
                                      256, 257, 512])
def test_blocks_per_sm_by_head_dim(head_dim):
    """As ``kMinBlocks`` in ``csrc/flash_decode.cu``: K3 at head_dim 256
    fits one block an SM at any group size, K4 one up to 4 rows a group
    (8 warps) and two above (4 warps); every smaller head dim two."""
    for int8 in (False, True):
        for rows in range(1, ta.GROUP_ROWS + 1):
            if head_dim not in ta.HEAD_DIMS:
                with pytest.raises(ValueError, match="head_dim"):
                    ta.blocks_per_sm(head_dim, int8, rows)
                continue
            want = 1 if head_dim == 256 and not (int8 and rows > 4) else 2
            assert ta.blocks_per_sm(head_dim, int8, rows) == want
    if head_dim in ta.HEAD_DIMS:
        for rows in (0, ta.GROUP_ROWS + 1):
            with pytest.raises(ValueError, match="group_rows"):
                ta.blocks_per_sm(head_dim, False, rows)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_split_rule_at_head_dim_256_covers_every_position_once(blocks):
    _covers_every_position_once(blocks, 1)


def test_split_rule_at_gemma2():
    """Gemma2-9B's 8 kv heads, 2 query rows (one group of 2: one block an
    SM): a pool of 2048 positions splits into one wave of at most 132
    blocks at B = 1, 4 and 8. At B = 4 a verify window of 16 positions
    (32 rows, four groups of 8: 128 blocks) does not split on K3 and
    splits in two on K4 (two blocks an SM); a generate's 76-position
    cache does not split."""
    one = ta.blocks_per_sm(256, False, 2)
    assert one == ta.blocks_per_sm(256, True, 2) == 1
    assert ta.decode_split(2048, 8, one) == (16, 128)
    assert ta.decode_split(2048, 32, one) == (4, 512)
    assert ta.decode_split(2048, 64, one) == (2, 1024)
    assert ta.decode_split(4352, 8, one) == (14, 320)
    assert ta.decode_split(76, 64, one) == (1, ta.SPLIT_MIN_CHUNK)
    n_groups, rows = ta.row_groups(16 * 2)
    assert (n_groups, rows) == (4, 8)
    assert ta.decode_split(2048, 4 * 8 * 4,
                           ta.blocks_per_sm(256, False, rows)) == (1, 2048)
    assert ta.decode_split(2048, 4 * 8 * 4,
                           ta.blocks_per_sm(256, True, rows)) == (2, 1024)


def split_combine(q, k, v, lengths, scale, softcap=None, window=None,
                  q_span=1, k_step=None, v_step=None, per_sm=2):
    """The kernel's split + combine in plain fp32 torch, on the rule's
    chunks and row groups at ``per_sm`` blocks an SM (two, as at every
    head dim up to 128, unless given): ``q [B, KVH, QG, D]`` against
    ``k, v [B, KVH, N, D]`` (a pool gathered through its table)."""
    B, kvh, QG, Dh = q.shape
    Gq = QG // q_span
    N = k.shape[2]
    n_groups, group_rows = ta.row_groups(QG)
    n_split, chunk = ta.decode_split(N, B * kvh * n_groups, per_sm)
    s = torch.einsum("bhrd,bhnd->bhrn", q.float() * scale, k.float())
    if k_step is not None:
        s = s * k_step.float()[:, :, None, :]
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    t = torch.arange(N)[None, None, None, :]
    qpos = (torch.arange(QG) // Gq)[None, None, :, None]
    ln = lengths.long()[:, None, None, None]
    vis = t < ln + qpos
    if window is not None:
        vis = vis & (t > ln - 1 + qpos - window)
    vf = v.float()
    out = torch.empty(B, kvh, QG, Dh)
    for g in range(n_groups):
        rows = slice(g * group_rows, min(QG, (g + 1) * group_rows))
        parts = []
        for sp in range(n_split):
            cols = slice(sp * chunk, min(N, (sp + 1) * chunk))
            vs = vis[:, :, rows, cols]
            ss = torch.where(vs, s[:, :, rows, cols], torch.tensor(NEG))
            m = ss.amax(-1, keepdim=True).clamp_min(NEG)
            p = torch.where(vs, torch.exp(ss - m), torch.zeros(()))
            l = p.sum(-1, keepdim=True)
            if v_step is not None:
                p = p * v_step.float()[:, :, None, cols]
            parts.append((m, l, torch.einsum("bhrn,bhnd->bhrd", p,
                                             vf[:, :, cols])))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = torch.zeros_like(M)
        A = torch.zeros(B, kvh, rows.stop - rows.start, Dh)
        for m, l, acc in parts:       # in split order; sum 0 adds nothing
            f = torch.where(l > 0, torch.exp(m - M), torch.zeros(()))
            L = L + f * l
            A = A + f * torch.where(l > 0, acc, torch.zeros(()))
        out[:, :, rows] = torch.where(L > 0, A / torch.where(L > 0, L, 1.0),
                                      A)
    return out


def _bf16(rng, shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)


def _i8(rng, shape):
    return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)


def _steps(rng, shape):
    return jnp.asarray(rng.uniform(0.005, 0.05, shape), jnp.bfloat16)


# (window, softcap): the window of 40 leaves row 1 (length 300) only
# positions 260-299, so its splits [0, 128) and [128, 256) see nothing
KNOBS = [(None, None), (40, None), (None, 30.0), (2 ** 30, 50.0)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window,softcap", KNOBS)
def test_split_combine_slot_matches_plain_and_jax(int8, window, softcap):
    rng = np.random.default_rng(11)
    L, B, S, li, attend = 2, 3, 512, 1, 448
    q = _bf16(rng, (B, KVH, G, D))
    lengths = np.asarray([1, 300, attend], np.int32)
    win = None if window is None else jnp.int32(window)
    common = dict(attend_len=attend, s_blk=64, interpret=True,
                  softcap=softcap, window=win)
    steps = {}
    if int8:
        ck, cv = _i8(rng, (L, B, KVH, S, D)), _i8(rng, (L, B, KVH, S, D))
        ks, vs = _steps(rng, (L, B, KVH, S)), _steps(rng, (L, B, KVH, S))
        ref = ja.flash_decode_attention_stacked_i8(
            q, ck, cv, ks, vs, jnp.int32(li), jnp.asarray(lengths), **common)
        steps = dict(k_step=_t(ks)[li, :, :, :attend],
                     v_step=_t(vs)[li, :, :, :attend])
    else:
        ck, cv = _bf16(rng, (L, B, KVH, S, D)), _bf16(rng, (L, B, KVH, S, D))
        ref = ja.flash_decode_attention_stacked(
            q, ck, cv, jnp.int32(li), jnp.asarray(lengths), **common)
    assert ta.decode_split(attend, B * KVH, 2)[0] == 4
    tq, tl = _t(q), _t(lengths)
    got = split_combine(tq, _t(ck)[li, :, :, :attend],
                        _t(cv)[li, :, :, :attend], tl, D ** -0.5, softcap,
                        window, **steps)
    plain = ta.decode_attention_plain(
        tq, _t(ck)[li, :, :, :attend], _t(cv)[li, :, :, :attend], tl,
        D ** -0.5, softcap, window, **steps)
    _close(got, plain)
    _close(got, ref)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("q_span", [1, 8])
@pytest.mark.parametrize("window,softcap", KNOBS)
def test_split_combine_paged_matches_plain_and_jax(int8, q_span, window,
                                                   softcap):
    rng = np.random.default_rng(12)
    L, B, P, page, mp = 2, 3, 22, 64, 8
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, mp), np.int32)           # unused entries: page 0
    table[0, :1] = perm[:1]
    table[1, :6] = perm[1:7]                      # 300 + q_span - 1 <= 384
    table[2, :8] = perm[7:15]
    lengths = np.asarray([1, 300, mp * page - q_span + 1], np.int32)
    q = _bf16(rng, (B, KVH, q_span * G, D))
    win = None if window is None else jnp.int32(window)
    common = dict(softcap=softcap, q_span=q_span, pages_per_step=2)
    if int8:
        pk, pv = _i8(rng, (L, P, KVH, page, D)), _i8(rng, (L, P, KVH, page, D))
        ks, vs = _steps(rng, (L, P, KVH, page)), _steps(rng, (L, P, KVH, page))
        ref = jpa.paged_flash_decode_attention_i8(
            q, pk, pv, ks, vs, jnp.asarray(table), jnp.int32(1),
            jnp.asarray(lengths), interpret=True, window=win, **common)
        steps = dict(k_step=tpa._gather(_t(ks), _t(table), 1),
                     v_step=tpa._gather(_t(vs), _t(table), 1))
        plain = tpa.paged_flash_decode_attention_i8(
            _t(q), _t(pk), _t(pv), _t(ks), _t(vs), _t(table), 1,
            _t(lengths), window=window, **common)
    else:
        pk, pv = (_bf16(rng, (L, P, KVH, page, D)),
                  _bf16(rng, (L, P, KVH, page, D)))
        ref = jpa.paged_flash_decode_attention(
            q, pk, pv, jnp.asarray(table), jnp.int32(1),
            jnp.asarray(lengths), interpret=True, window=win, **common)
        steps = {}
        plain = tpa.paged_flash_decode_attention(
            _t(q), _t(pk), _t(pv), _t(table), 1,
            _t(lengths), window=window, **common)
    n_groups = ta.row_groups(q_span * G)[0]
    assert n_groups == (4 if q_span == 8 else 1)
    assert ta.decode_split(mp * page, B * KVH * n_groups, 2)[0] == 4
    got = split_combine(_t(q), tpa._gather(_t(pk), _t(table), 1),
                        tpa._gather(_t(pv), _t(table), 1), _t(lengths),
                        D ** -0.5, softcap, window, q_span, **steps)
    _close(got, plain)
    _close(got, ref)


@pytest.mark.parametrize("int8", [False, True])
def test_split_combine_row_that_sees_nothing_is_zero(int8):
    """Length 0 (a slot cache row), or a window past every position of
    the first splits: zeros where nothing is seen, no NaN."""
    rng = np.random.default_rng(13)
    B, S = 2, 384
    q = _t(_bf16(rng, (B, KVH, G, D)))
    if int8:
        k, v = _t(_i8(rng, (B, KVH, S, D))), _t(_i8(rng, (B, KVH, S, D)))
        steps = dict(k_step=_t(_steps(rng, (B, KVH, S))),
                     v_step=_t(_steps(rng, (B, KVH, S))))
    else:
        k, v = _t(_bf16(rng, (B, KVH, S, D))), _t(_bf16(rng, (B, KVH, S, D)))
        steps = {}
    lengths = torch.tensor([0, 350], dtype=torch.int32)
    for window in (None, 3):
        got = split_combine(q, k, v, lengths, D ** -0.5, window=window,
                            **steps)
        plain = ta.decode_attention_plain(q, k, v, lengths, D ** -0.5,
                                          window=window, **steps)
        assert torch.isfinite(got).all() and (got[0] == 0).all()
        _close(got, plain)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("q_span", [1, 16])
def test_split_combine_head_dim_256_matches_plain_and_jax(int8, q_span):
    """Gemma-2's head_dim 256, G 2, softcap 50 and a window of 100 that
    the long row passes, on the pool: 4 splits of 128 positions, at one
    group (q_span 1) and at four groups of 8 rows (q_span 16)."""
    rng = np.random.default_rng(14)
    Dg, Gg, window, softcap = 256, 2, 100, 50.0
    L, B, P, page, mp = 2, 3, 30, 64, 8
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, mp), np.int32)
    table[0, :1] = perm[:1]
    table[1, :6] = perm[1:7]
    table[2, :8] = perm[7:15]
    lengths = np.asarray([1, 300, mp * page - q_span + 1], np.int32)
    q = _bf16(rng, (B, KVH, q_span * Gg, Dg))
    common = dict(softcap=softcap, q_span=q_span, pages_per_step=2)
    shape = (L, P, KVH, page, Dg)
    if int8:
        pk, pv = _i8(rng, shape), _i8(rng, shape)
        ks, vs = _steps(rng, shape[:-1]), _steps(rng, shape[:-1])
        ref = jpa.paged_flash_decode_attention_i8(
            q, pk, pv, ks, vs, jnp.asarray(table), jnp.int32(1),
            jnp.asarray(lengths), interpret=True, window=jnp.int32(window),
            **common)
        steps = dict(k_step=tpa._gather(_t(ks), _t(table), 1),
                     v_step=tpa._gather(_t(vs), _t(table), 1))
        plain = tpa.paged_flash_decode_attention_i8(
            _t(q), _t(pk), _t(pv), _t(ks), _t(vs), _t(table), 1,
            _t(lengths), window=window, **common)
    else:
        pk, pv = _bf16(rng, shape), _bf16(rng, shape)
        ref = jpa.paged_flash_decode_attention(
            q, pk, pv, jnp.asarray(table), jnp.int32(1),
            jnp.asarray(lengths), interpret=True, window=jnp.int32(window),
            **common)
        steps = {}
        plain = tpa.paged_flash_decode_attention(
            _t(q), _t(pk), _t(pv), _t(table), 1, _t(lengths), window=window,
            **common)
    n_groups, rows = ta.row_groups(q_span * Gg)
    assert n_groups == (4 if q_span == 16 else 1)
    per_sm = ta.blocks_per_sm(Dg, int8, rows)
    assert ta.decode_split(mp * page, B * KVH * n_groups, per_sm) == (4, 128)
    got = split_combine(_t(q), tpa._gather(_t(pk), _t(table), 1),
                        tpa._gather(_t(pv), _t(table), 1), _t(lengths),
                        Dg ** -0.5, softcap, window, q_span, per_sm=per_sm,
                        **steps)
    _close(got, plain)
    _close(got, ref)
