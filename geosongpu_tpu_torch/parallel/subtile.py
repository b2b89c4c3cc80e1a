"""Subtile (NX x NY per face) halo exchange and the sharded model step
(geosongpu_tpu/parallel/subtile.py).

Each cube face is cut into a py x px grid of blocks, as the original's MPI
rank layouts cut it:

* **faces-local** (``face_sharded=False``): a (py, px) rank grid; every
  rank holds the same (by, bx) block of all 6 faces (6 slots);
* **face-sharded** (``face_sharded=True``): a (6, py, px) rank grid; one
  rank holds one block of one face (1 slot), the original's 6*NX*NY rank
  layout.  With py = px = 1 it is the one-face-per-rank layout, which the
  JAX package also runs through a path of its own (its
  parallel/shard_halo.py and dycore/sharded.py); the port runs it here,
  held to that path by tests/test_torch_shard_halo.py.

Every exchange is compiled from per-cell source maps (core/topology's
halo_spec, the tables of the single-device fills): each padded halo cell
of each rank resolves to its owning rank and that rank's local flat index;
the cells a rank needs from one peer form one deduplicated message;
messages are edge-coloured into rounds, each one partial permutation of
the ranks; a rank's padded array is then one gather from
``cat(local interior, zero, recv_0, ..., recv_R)`` through a static index
table, with the orientation and the D/C-grid signs in the tables.  The
numpy plan (`SubtileLayout` ... `unstack_blocks`, `layout_from_mesh`) is
the port's own copy of the reference's, held to it bit for bit by
tests/test_torch_subtile.py.

The rounds ride a rank group (parallel/comm.py): stacked ranks in one
process, or one rank per process over torch.distributed.  Local arrays
carry the held ranks and their slots folded into the leading axis,
[ranks x slots, rows, cols, ...], so every kernel of the dycore runs once
for all the ranks a process holds, on rectangular blocks.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.topology import NFACES, halo_spec
from ..device import to_torch
from ..spans import span, spanned
from .comm import ProcessGroup, RankGroup, StackedGroup, available_ranks


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SubtileLayout:
    """Static description of a subtile decomposition."""

    n: int                 # cells per face edge
    h: int                 # halo width
    py: int                # blocks per face edge, y
    px: int                # blocks per face edge, x
    face_sharded: bool     # True: rank grid (6, py, px); False: (py, px)

    def __post_init__(self):
        assert self.n % self.py == 0 and self.n % self.px == 0, (
            "face edge must divide evenly into the block grid")

    @property
    def bny(self) -> int:
        return self.n // self.py

    @property
    def bnx(self) -> int:
        return self.n // self.px

    @property
    def nslots(self) -> int:
        """Faces held per rank."""
        return 1 if self.face_sharded else NFACES

    @property
    def ndevices(self) -> int:
        base = self.py * self.px
        return NFACES * base if self.face_sharded else base

    def dev_coords(self, d: int) -> Tuple[int, int, int]:
        """rank -> (face (or -1), by, bx)."""
        if self.face_sharded:
            f, rem = divmod(d, self.py * self.px)
            by, bx = divmod(rem, self.px)
            return f, by, bx
        by, bx = divmod(d, self.px)
        return -1, by, bx

    def owner_scalar(self, f, j, i):
        """Owning rank of cell-centred (face, j, i) (vectorised)."""
        oby = j // self.bny
        obx = i // self.bnx
        if self.face_sharded:
            return (f * self.py + oby) * self.px + obx
        return oby * self.px + obx


# --------------------------------------------------------------------------
# plan (numpy)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class _Round:
    perm: Tuple[Tuple[int, int], ...]   # (src, dst) pairs, a partial perm
    msg_len: int
    pack_idx: np.ndarray                # [D, msg_len] into local-flat+zero


@dataclass(frozen=True)
class _Exchange:
    """One exchange family (scalar or staggered): rounds + unpack tables."""

    local_len: int                      # flat local source segment length
    rounds: Tuple[_Round, ...]
    # dest-name -> (idx [D, cells], sign [D, cells] or None, out_shape)
    unpack: Dict[str, Tuple[np.ndarray, Optional[np.ndarray], Tuple[int, ...]]]


@dataclass(frozen=True)
class _TwinPlan:
    """Cross-rank shared-edge symmetrization tables (the sharded form of
    parallel/halo.symmetrize_shared_edges).  Per rank, padded to the
    largest entry count: tgt [D, m] the local flat position (u then v) of
    a face-boundary staggered entry the rank holds (pad = local_len,
    dropped); pos [D, m] the position of its twin's value in the exchange
    buffer; sgn [D, m] the pair's tangent sign."""

    rounds: Tuple[_Round, ...]
    tgt: np.ndarray
    pos: np.ndarray
    sgn: np.ndarray
    local_len: int


@dataclass(frozen=True)
class SubtilePlan:
    layout: SubtileLayout
    scalar: _Exchange     # dests: 'x', 'y'
    stag: _Exchange       # dests: 'u_t', 'v_t', 'u_n', 'v_n' (idx shared)
    twins: Optional[_TwinPlan] = None


def _schedule(pairs: Dict[Tuple[int, int], np.ndarray], D: int
              ) -> Tuple[List[_Round], Dict[Tuple[int, int], Tuple[int, int]]]:
    """Greedy edge-colouring of the (src -> dst) message multigraph into
    rounds where each rank sends and receives at most once.  Returns the
    rounds and, per pair, its round index."""
    order = sorted(pairs.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    buckets: List[Dict] = []
    assign: Dict[Tuple[int, int], int] = {}
    for (s, d), cells in order:
        placed = False
        for r, b in enumerate(buckets):
            if s not in b["senders"] and d not in b["receivers"]:
                b["senders"].add(s)
                b["receivers"].add(d)
                b["pairs"].append((s, d))
                assign[(s, d)] = r
                placed = True
                break
        if not placed:
            buckets.append({"senders": {s}, "receivers": {d},
                            "pairs": [(s, d)]})
            assign[(s, d)] = len(buckets) - 1
    rounds: List[_Round] = []
    for r, b in enumerate(buckets):
        m = max(len(pairs[p]) for p in b["pairs"])
        pack = np.full((D, m), -1, np.int64)  # -1 patched to zero-idx later
        for (s, d) in b["pairs"]:
            cells = pairs[(s, d)]
            pack[s, :len(cells)] = cells
        rounds.append(_Round(perm=tuple(sorted(b["pairs"])), msg_len=m,
                             pack_idx=pack))
    return rounds, assign


class _PlanAccum:
    """Accumulates (dest cell -> source) relations for one exchange family
    across all ranks, then resolves messages, rounds and unpack tables."""

    def __init__(self, layout: SubtileLayout, local_len: int):
        self.layout = layout
        self.local_len = local_len
        self.D = layout.ndevices
        self._pair_cells: Dict[Tuple[int, int], List[np.ndarray]] = {}
        self._dests: Dict[str, List[Tuple]] = {}
        self._shapes: Dict[str, Tuple[int, ...]] = {}

    def add_dest(self, name: str, d: int, is_local: np.ndarray,
                 local_idx: np.ndarray, src_dev: np.ndarray,
                 sender_idx: np.ndarray, sign: Optional[np.ndarray],
                 out_shape: Tuple[int, ...]):
        self._shapes[name] = out_shape
        self._dests.setdefault(name, [])
        assert len(self._dests[name]) == d, "ranks must be added in order"
        self._dests[name].append(
            (is_local, local_idx, src_dev, sender_idx, sign))
        remote = ~is_local
        if remote.any():
            sd = src_dev[remote]
            si = sender_idx[remote]
            for s in np.unique(sd):
                self._pair_cells.setdefault((int(s), d), []).append(
                    si[sd == s])

    def finish(self) -> _Exchange:
        pairs = {k: np.unique(np.concatenate(v))
                 for k, v in self._pair_cells.items()}
        rounds, assign = _schedule(pairs, self.D)
        # receiver concat layout: [local, zero, recv_0, ..., recv_{R-1}]
        seg_base = [self.local_len + 1]
        for r in rounds:
            seg_base.append(seg_base[-1] + r.msg_len)
        unpack: Dict[str, Tuple] = {}
        for name, per_dev in self._dests.items():
            cells = per_dev[0][0].size
            idx = np.zeros((self.D, cells), np.int64)
            sgn = None
            for d, (is_local, local_idx, src_dev, sender_idx, sign
                    ) in enumerate(per_dev):
                row = np.where(is_local, local_idx, 0)
                remote = ~is_local
                if remote.any():
                    sd = src_dev[remote]
                    si = sender_idx[remote]
                    pos = np.zeros(si.shape, np.int64)
                    for s in np.unique(sd):
                        msk = sd == s
                        msg = pairs[(int(s), d)]
                        pos[msk] = (seg_base[assign[(int(s), d)]]
                                    + np.searchsorted(msg, si[msk]))
                    row[remote] = pos
                idx[d] = row
                if sign is not None:
                    if sgn is None:
                        sgn = np.ones((self.D, cells), np.int8)
                    sgn[d] = sign
            unpack[name] = (idx.astype(np.int32), sgn, self._shapes[name])
        # patch pack padding (-1 -> zero cell at local_len)
        patched = []
        for r in rounds:
            pk = r.pack_idx.copy()
            pk[pk < 0] = self.local_len
            patched.append(_Round(perm=r.perm, msg_len=r.msg_len,
                                  pack_idx=pk.astype(np.int32)))
        return _Exchange(local_len=self.local_len, rounds=tuple(patched),
                         unpack=unpack)


@functools.lru_cache(maxsize=8)
def build_subtile_plan(n: int, h: int, py: int, px: int,
                       face_sharded: bool = False) -> SubtilePlan:
    lay = SubtileLayout(n=n, h=h, py=py, px=px, face_sharded=face_sharded)
    spec = halo_spec(n, h)
    bny, bnx, S, D = lay.bny, lay.bnx, lay.nslots, lay.ndevices
    Npy, Npx = bny + 2 * h, bnx + 2 * h

    # ---- scalar (cell-centred) exchange ---------------------------------
    dec = {}
    for t, g in (("x", spec.gidx_x), ("y", spec.gidx_y)):
        dec[t] = (g // (n * n), (g // n) % n, g % n)   # (face, j, i) [6,N,N]

    scalar = _PlanAccum(lay, local_len=S * bny * bnx)
    for d in range(D):
        fd, by, bx = lay.dev_coords(d)
        faces = [fd] if face_sharded else list(range(NFACES))
        for t in ("x", "y"):
            sf_t, sj_t, si_t = dec[t]
            SF, SJ, SI = [], [], []
            for f in faces:
                sl = (slice(by * bny, by * bny + Npy),
                      slice(bx * bnx, bx * bnx + Npx))
                SF.append(sf_t[f][sl])
                SJ.append(sj_t[f][sl])
                SI.append(si_t[f][sl])
            qf = np.stack(SF).ravel().astype(np.int64)
            qj = np.stack(SJ).ravel().astype(np.int64)
            qi = np.stack(SI).ravel().astype(np.int64)
            oby, obx = qj // bny, qi // bnx
            src_dev = lay.owner_scalar(qf, qj, qi)
            slot_src = np.zeros_like(qf) if face_sharded else qf
            if face_sharded:
                is_local = (qf == fd) & (oby == by) & (obx == bx)
            else:
                is_local = (oby == by) & (obx == bx)
            local_idx = ((slot_src * bny + (qj - by * bny)) * bnx
                         + (qi - bx * bnx))
            sender_idx = ((slot_src * bny + (qj - oby * bny)) * bnx
                          + (qi - obx * bnx))
            scalar.add_dest(t, d, is_local, local_idx, src_dev, sender_idx,
                            None, (S, Npy, Npx))
    scalar_ex = scalar.finish()

    # ---- staggered (D/C-grid) exchange ----------------------------------
    # u [6, n+1, n] and v [6, n, n+1] concat-flat source; blocks hold
    # bny+1 / bnx+1 with duplicated shared interfaces (both neighbours
    # prognose them identically), so interface cells resolve locally.
    u_count = NFACES * (n + 1) * n
    u_seg = S * (bny + 1) * bnx         # local flat layout: u then v

    def decode_stag(idx):
        is_v = idx >= u_count
        g = np.where(is_v, (idx - u_count) // (n * (n + 1)),
                     idx // ((n + 1) * n))
        rem_u = idx % ((n + 1) * n)
        rem_v = (idx - u_count) % (n * (n + 1))
        j = np.where(is_v, rem_v // (n + 1), rem_u // n)
        i = np.where(is_v, rem_v % (n + 1), rem_u % n)
        return is_v, g, j, i

    stag = _PlanAccum(lay, local_len=u_seg + S * bny * (bnx + 1))
    for d in range(D):
        fd, by, bx = lay.dev_coords(d)
        faces = [fd] if face_sharded else list(range(NFACES))
        for name, table, sgn_t_tab, sgn_n_tab, rows, cols, shape in (
                ("u", spec.u_idx, spec.u_sgn, spec.u_sgn_n,
                 Npy + 1, Npx, (S, Npy + 1, Npx)),
                ("v", spec.v_idx, spec.v_sgn, spec.v_sgn_n,
                 Npy, Npx + 1, (S, Npy, Npx + 1))):
            IDX, ST, SN = [], [], []
            for f in faces:
                sl = (slice(by * bny, by * bny + rows),
                      slice(bx * bnx, bx * bnx + cols))
                IDX.append(table[f][sl])
                ST.append(sgn_t_tab[f][sl])
                SN.append(sgn_n_tab[f][sl])
            idx = np.stack(IDX).ravel().astype(np.int64)
            st = np.stack(ST).ravel().astype(np.int8)
            sn = np.stack(SN).ravel().astype(np.int8)
            is_v, qg, qj, qi = decode_stag(idx)
            slot_src = np.zeros_like(qg) if face_sharded else qg
            # locality: the block holds rows [by*bny, by*bny+bny] of u
            # (inclusive) and cols [bx*bnx, bx*bnx+bnx] of v
            loc_u = ((qj >= by * bny) & (qj <= by * bny + bny)
                     & (qi >= bx * bnx) & (qi < bx * bnx + bnx))
            loc_v = ((qj >= by * bny) & (qj < by * bny + bny)
                     & (qi >= bx * bnx) & (qi <= bx * bnx + bnx))
            on_my_block = np.where(is_v, loc_v, loc_u)
            face_ok = (qg == fd) if face_sharded else np.ones_like(qg,
                                                                   bool)
            is_local = on_my_block & face_ok
            # owner: staggered rows/cols at block interfaces go to the
            # higher block (min caps the last interface into the last row)
            oby = np.where(is_v, qj // bny, np.minimum(qj // bny, py - 1))
            obx = np.where(is_v, np.minimum(qi // bnx, px - 1), qi // bnx)
            if face_sharded:
                src_dev = (qg * py + oby) * px + obx
            else:
                src_dev = oby * px + obx

            def flat(sv, bby, bbx):
                fu = (slot_src * (bny + 1) + (qj - bby * bny)) * bnx \
                    + (qi - bbx * bnx)
                fv = u_seg + (slot_src * bny + (qj - bby * bny)) \
                    * (bnx + 1) + (qi - bbx * bnx)
                return np.where(sv, fv, fu)

            local_idx = flat(is_v, by, bx)
            sender_idx = flat(is_v, oby, obx)
            stag.add_dest(f"{name}_t", d, is_local, local_idx, src_dev,
                          sender_idx, st, shape)
            stag.add_dest(f"{name}_n", d, is_local, local_idx, src_dev,
                          sender_idx, sn, shape)
    stag_ex = stag.finish()

    return SubtilePlan(layout=lay, scalar=scalar_ex, stag=stag_ex,
                       twins=_build_twin_plan(lay))


def _build_twin_plan(lay: SubtileLayout) -> _TwinPlan:
    """Shared-edge twin exchange plan (see _TwinPlan).

    Every face-boundary staggered entry (u rows 0/n, v cols 0/n) has
    exactly one holder rank per face copy, so the per-rank entry lists need
    no duplicate handling.  Each holder computes 0.5 * (mine + sign *
    twin), which equals the single-device symmetrize_shared_edges update
    bit for bit on both sides (multiplication by +-1 is exact)."""
    from ..core.topology import edge_twins

    n, py, px = lay.n, lay.py, lay.px
    bny, bnx, S, D = lay.bny, lay.bnx, lay.nslots, lay.ndevices
    face_sharded = lay.face_sharded
    idx_a, idx_b, sgn_ab = edge_twins(n)
    twin_of: Dict[int, Tuple[int, int]] = {}
    for a, b, s in zip(idx_a.tolist(), idx_b.tolist(), sgn_ab.tolist()):
        twin_of[a] = (b, int(s))
        twin_of[b] = (a, int(s))

    u_count = NFACES * (n + 1) * n
    u_seg = S * (bny + 1) * bnx
    local_len = u_seg + S * bny * (bnx + 1)

    def decode(g):
        if g >= u_count:
            rem = g - u_count
            f, rem = divmod(rem, n * (n + 1))
            j, i = divmod(rem, n + 1)
            return True, f, j, i
        f, rem = divmod(g, (n + 1) * n)
        j, i = divmod(rem, n)
        return False, f, j, i

    def owner(is_v, f, j, i):
        if is_v:
            oby, obx = j // bny, min(i // bnx, px - 1)
        else:
            oby, obx = min(j // bny, py - 1), i // bnx
        return ((f * py + oby) * px + obx if face_sharded
                else oby * px + obx), oby, obx

    def local_flat(is_v, slot, j, i, oby, obx):
        if is_v:
            return u_seg + (slot * bny + (j - oby * bny)) * (bnx + 1) \
                + (i - obx * bnx)
        return (slot * (bny + 1) + (j - oby * bny)) * bnx + (i - obx * bnx)

    per_dev: List[List[Tuple[int, int, int, int, int]]] = [
        [] for _ in range(D)]  # (tgt_local, src_dev, src_local, sign, _)
    pair_cells: Dict[Tuple[int, int], List[int]] = {}
    for g, (g2, s) in twin_of.items():
        is_v, f, j, i = decode(g)
        d, oby, obx = owner(is_v, f, j, i)
        slot = 0 if face_sharded else f
        tgt = local_flat(is_v, slot, j, i, oby, obx)
        is_v2, f2, j2, i2 = decode(g2)
        d2, oby2, obx2 = owner(is_v2, f2, j2, i2)
        slot2 = 0 if face_sharded else f2
        src = local_flat(is_v2, slot2, j2, i2, oby2, obx2)
        per_dev[d].append((tgt, d2, src, s, g))
        if d2 != d:
            pair_cells.setdefault((d2, d), []).append(src)

    pairs = {k: np.unique(np.asarray(v, np.int64))
             for k, v in pair_cells.items()}
    rounds, assign = _schedule(pairs, D)
    seg_base = [local_len + 1]
    for r in rounds:
        seg_base.append(seg_base[-1] + r.msg_len)

    m = max((len(e) for e in per_dev), default=0)
    tgt = np.full((D, m), local_len, np.int32)   # pad -> dropped scatter
    pos = np.zeros((D, m), np.int32)
    sg = np.zeros((D, m), np.int8)
    for d, entries in enumerate(per_dev):
        for k, (t, d2, src, s, _g) in enumerate(entries):
            tgt[d, k] = t
            sg[d, k] = s
            if d2 == d:
                pos[d, k] = src
            else:
                msg = pairs[(d2, d)]
                pos[d, k] = (seg_base[assign[(d2, d)]]
                             + int(np.searchsorted(msg, src)))
    patched = []
    for r in rounds:
        pk = r.pack_idx.copy()
        pk[pk < 0] = local_len
        patched.append(_Round(perm=r.perm, msg_len=r.msg_len,
                              pack_idx=pk.astype(np.int32)))
    return _TwinPlan(rounds=tuple(patched), tgt=tgt, pos=pos, sgn=sg,
                     local_len=local_len)


# --------------------------------------------------------------------------
# filler (the HaloOps interface on a rank group)
# --------------------------------------------------------------------------

class SubtileFiller:
    """HaloOps' interface for the blocks of the ranks `group` holds.

    Local arrays are [R*S, rows, cols, ...]: the R held ranks' S slots
    each.  ny, nx are the block's extents (the dycore slices through them,
    so blocks need not be square).  comm=False skips the rounds: halo
    segments then read the sender's own packed data, the same local work
    without communication (the compute-only leg of the scaling task); the
    step is then not a correct model step."""

    def __init__(self, plan: SubtilePlan, group: RankGroup,
                 comm: bool = True):
        lay = plan.layout
        self.group = group
        self.comm = comm
        self.h = lay.h
        self.ny = lay.bny
        self.nx = lay.bnx
        self.device = group.device
        ranks = np.asarray(group.ranks, np.int64)
        self._R = len(ranks)
        dev = group.device

        def rows(table, width):
            """Rows of the held ranks, offset into the flattened
            [R * width] buffer of the held ranks."""
            t = np.asarray(table, np.int64)[ranks]
            t = t + (np.arange(len(ranks)) * width)[:, None]
            return to_torch(t.reshape(-1), dev)

        def pack_rounds(ex):
            """The rounds with their pack rows, and the width of the
            exchange buffer of a rank."""
            rounds = [(r.perm, r.msg_len, rows(r.pack_idx, ex.local_len + 1))
                      for r in ex.rounds]
            return rounds, ex.local_len + 1 + sum(r.msg_len
                                                  for r in ex.rounds)

        def family(ex: _Exchange):
            rounds, width = pack_rounds(ex)
            unpack = {}
            for k, (idx, sgn, shp) in ex.unpack.items():
                s = None if sgn is None else to_torch(
                    sgn[ranks].astype(np.float32).reshape(-1), dev)
                unpack[k] = (rows(idx, width), s, shp)
            return rounds, unpack

        self._sc_rounds, self._sc_unpack = family(plan.scalar)
        self._st_rounds, self._st_unpack = family(plan.stag)
        tw = plan.twins
        self._tw = None
        if tw is not None:
            rounds, width = pack_rounds(tw)
            self._tw = (rounds, rows(tw.tgt, tw.local_len + 1),
                        rows(tw.tgt, width), rows(tw.pos, width),
                        to_torch(tw.sgn[ranks].astype(np.float32)
                                 .reshape(-1), dev))

    # -- exchange core ---------------------------------------------------
    def _exchange(self, src: torch.Tensor, rounds) -> torch.Tensor:
        """src [R, L+1, ...] (zero row appended) -> [R, L+1+sum(m), ...],
        src and every round's receive buffer."""
        R = self._R
        trail = src.shape[2:]
        flat = src.reshape((-1,) + trail)
        parts = [src]
        for perm, m, pack in rounds:
            msg = flat.index_select(0, pack).reshape((R, m) + trail)
            if self.comm:
                msg = self.group.permute(msg, perm)
            parts.append(msg)
        return torch.cat(parts, dim=1) if len(parts) > 1 else src

    def _unpack(self, full, table):
        idx, sgn, shp = table
        trail = full.shape[2:]
        out = full.reshape((-1,) + trail).index_select(0, idx)
        if sgn is not None:
            out = out * sgn.view((-1,) + (1,) * len(trail))
        return out.reshape((self._R * shp[0],) + shp[1:] + trail)

    def _with_zero(self, *fields):
        """[R*S, ...] fields -> [R, L+1, ...]: each rank's fields flat, one
        after the other, and a zero row."""
        R = self._R
        trail = fields[0].shape[3:]
        flats = [f.reshape((R, -1) + trail) for f in fields]
        flats.append(flats[0].new_zeros((R, 1) + trail))
        return torch.cat(flats, dim=1)

    # -- scalar, cell-centred --------------------------------------------
    @spanned("halo.fill")
    def fill(self, field: torch.Tensor, direction: str = "x") -> torch.Tensor:
        if direction not in ("x", "y"):
            raise ValueError(f"direction must be 'x' or 'y', got {direction!r}")
        full = self._exchange(self._with_zero(field), self._sc_rounds)
        return self._unpack(full, self._sc_unpack[direction])

    # -- D-grid staggered winds ------------------------------------------
    @spanned("halo.fill_dgrid")
    def fill_dgrid(self, u: torch.Tensor, v: torch.Tensor):
        full = self._exchange(self._with_zero(u, v), self._st_rounds)
        return (self._unpack(full, self._st_unpack["u_t"]),
                self._unpack(full, self._st_unpack["v_t"]))

    # -- C-grid staggered normal winds -----------------------------------
    @spanned("halo.fill_cgrid")
    def fill_cgrid(self, uc: torch.Tensor, vc: torch.Tensor):
        # vc has u's staggering, uc has v's (as HaloOps.fill_cgrid);
        # messages carry raw values, the normal signs are in the tables
        full = self._exchange(self._with_zero(vc, uc), self._st_rounds)
        return (self._unpack(full, self._st_unpack["v_n"]),
                self._unpack(full, self._st_unpack["u_n"]))

    # -- shared-edge symmetrization --------------------------------------
    @spanned("halo.symmetrize")
    def symmetrize_dgrid(self, u: torch.Tensor, v: torch.Tensor):
        """Sharded form of parallel/halo.symmetrize_shared_edges: average
        the two independently prognosed copies of every face-boundary
        staggered wind entry, the twins' values exchanged over rounds.
        Each holder computes 0.5 * (mine + sign * twin), the single-device
        update bit for bit on both sides."""
        if self._tw is None:
            return u, v
        rounds, tgt_src, tgt_full, pos, sgn = self._tw
        R = self._R
        trail = u.shape[3:]
        src = self._with_zero(u, v)                  # [R, L+1, ...]
        full = self._exchange(src, rounds).reshape((-1,) + trail)
        s = sgn.view((-1,) + (1,) * len(trail))
        new = 0.5 * (full.index_select(0, tgt_full)
                     + s * full.index_select(0, pos))
        # padded entries point at each rank's zero row: written, then cut
        out = src.reshape((-1,) + trail).index_copy(0, tgt_src, new)
        out = out.reshape(src.shape)[:, :-1]
        nu = u.shape[0] * u.shape[1] * u.shape[2] // R
        return (out[:, :nu].reshape(u.shape), out[:, nu:].reshape(v.shape))

    def interior(self, padded: torch.Tensor) -> torch.Tensor:
        h = self.h
        return padded[:, h:h + self.ny, h:h + self.nx]

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)


# --------------------------------------------------------------------------
# block placement (global [6, ...] <-> rank-stacked [D, S, ...])
# --------------------------------------------------------------------------

def _block_slices(lay: SubtileLayout, size_y: int, size_x: int, by: int,
                  bx: int) -> Tuple[slice, slice]:
    """Slices of a global (possibly staggered/padded) axis pair for block
    (by, bx).  Unpadded: size n -> bn cells, n+1 -> bn+1 (shared
    interfaces duplicated).  Padded (size n+2h / n+1+2h): the block keeps
    its own halo band."""
    n, h = lay.n, lay.h
    bny, bnx = lay.bny, lay.bnx

    def one(size, b, bn):
        if size == n:
            return slice(b * bn, (b + 1) * bn)
        if size == n + 1:
            return slice(b * bn, b * bn + bn + 1)
        if size == n + 2 * h:
            return slice(b * bn, b * bn + bn + 2 * h)
        if size == n + 1 + 2 * h:
            return slice(b * bn, b * bn + bn + 1 + 2 * h)
        raise ValueError(f"axis size {size} does not match n={n}, h={h}")

    return one(size_y, by, bny), one(size_x, bx, bnx)


def stack_blocks(lay: SubtileLayout, arr) -> np.ndarray:
    """Global [6, sy, sx, ...] -> rank-stacked [D, S, by, bx, ...]."""
    arr = np.asarray(arr)
    out = []
    for d in range(lay.ndevices):
        fd, by, bx = lay.dev_coords(d)
        js, is_ = _block_slices(lay, arr.shape[1], arr.shape[2], by, bx)
        blk = arr[:, js, is_]
        if lay.face_sharded:
            blk = blk[fd:fd + 1]
        out.append(blk)
    return np.stack(out, axis=0)


def unstack_blocks(lay: SubtileLayout, stacked, sy: int, sx: int
                   ) -> np.ndarray:
    """Inverse of stack_blocks (duplicated interface rows/cols agree by
    the shared-edge contract; last writer wins)."""
    stacked = np.asarray(stacked)
    out = np.zeros((NFACES, sy, sx) + stacked.shape[4:], stacked.dtype)
    for d in range(lay.ndevices):
        fd, by, bx = lay.dev_coords(d)
        js, is_ = _block_slices(lay, sy, sx, by, bx)
        if lay.face_sharded:
            out[fd, js, is_] = stacked[d, 0]
        else:
            out[:, js, is_] = stacked[d]
    return out


def place_array(lay: SubtileLayout, group: RankGroup, a) -> torch.Tensor:
    """Global [6, sy, sx, ...] (numpy or tensor) -> the held ranks' blocks
    [R*S, by, bx, ...] on the group's device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    st = stack_blocks(lay, a)[list(group.ranks)]
    return to_torch(st.reshape((-1,) + st.shape[2:]), group.device)


def unplace_array(lay: SubtileLayout, group: RankGroup, local: torch.Tensor
                  ) -> torch.Tensor:
    """Inverse of place_array: every rank's blocks gathered, unstacked to
    the global [6, sy, sx, ...] on the group's device."""
    a = group.gather(local).detach().cpu().numpy()
    a = a.reshape((lay.ndevices, lay.nslots) + a.shape[1:])
    sy = lay.n + (a.shape[2] - lay.bny)   # recover the global staggering
    sx = lay.n + (a.shape[3] - lay.bnx)
    return to_torch(unstack_blocks(lay, a, sy, sx), group.device)


# --------------------------------------------------------------------------
# sharded model step
# --------------------------------------------------------------------------

def _place_tuple(lay, group, tup):
    return type(tup)(*(place_array(lay, group, a) for a in tup))


def build_subtile_step(ctx, lay: SubtileLayout, group: RankGroup = None,
                       lats=None, forcing=None, comm: bool = True):
    """Sharded full-model step over a subtile layout.

    ctx: the DycoreContext of the global grid (single-device).  group: the
    rank group (default: all ranks stacked on ctx's device).  forcing(state,
    lats_local) -> state applies the column physics on the held blocks;
    lats: the global HSLatitudes, cut per block.  Both dycore forms shard:
    the fused kernels take rectangular blocks and any slot count.

    Returns (step, place, unplace): place/unplace move a global
    DycoreState onto/off the ranks; step runs one model step, and
    `step.ctx` is the blocks' DycoreContext (its ops the SubtileFiller)."""
    from ..core.chart_corners import sharded_chart_for_subtile
    from ..core.state import DycoreState
    from ..dycore.fv_dynamics import (DycoreContext, _make_remap,
                                      fv_dynamics_step)

    if group is None:
        group = StackedGroup(lay.ndevices, ctx.device)
    if group.size != lay.ndevices:
        raise ValueError(f"layout needs {lay.ndevices} ranks, the group "
                         f"has {group.size}")
    plan = build_subtile_plan(lay.n, lay.h, lay.py, lay.px,
                              lay.face_sharded)
    cfg = ctx.config
    filler = SubtileFiller(plan, group, comm=comm)
    chart = None
    if ctx.chart is not None:
        # None when blocks are too small for the corner patches: such
        # layouts run without the corner correction, as the original's
        chart = sharded_chart_for_subtile(ctx.chart, lay, group.ranks)
    lctx = DycoreContext(
        ops=filler, metrics=_place_tuple(lay, group, ctx.metrics),
        ak=ctx.ak, bk=ctx.bk, config=cfg, chart=chart,
        stag=None if ctx.stag is None else _place_tuple(lay, group,
                                                        ctx.stag))
    lats_l = None if lats is None else _place_tuple(lay, group, lats)
    remap = _make_remap(cfg, ctx.device)

    @spanned("step")
    def step(state):
        with span("dynamics"):
            out = fv_dynamics_step(state, lctx, remap=remap)
        if forcing is not None:
            out = forcing(out, lats_l)
        if cfg.edge_symmetrize:
            # after the forcing, as the single-device model does
            with span("symmetrize"):
                u, v = filler.symmetrize_dgrid(out.u, out.v)
                out = dataclasses.replace(out, u=u, v=v)
        return out

    step.ctx = lctx

    def place(state):
        return DycoreState(**{f.name: place_array(lay, group,
                                                  getattr(state, f.name))
                              for f in dataclasses.fields(state)})

    def unplace(state):
        return DycoreState(**{f.name: unplace_array(lay, group,
                                                    getattr(state, f.name))
                              for f in dataclasses.fields(state)})

    return step, place, unplace


# --------------------------------------------------------------------------
# MeshConfig -> stepper (the experiment pipeline's entry point)
# --------------------------------------------------------------------------

def layout_from_mesh(mesh_cfg, npx: int, halo: int) -> SubtileLayout:
    """Experiment MeshConfig (core/config.py) -> SubtileLayout.

    face=6 is the original's 6*NX*NY rank layout (one rank owns one block
    of one face); face=1 the faces-local layout (every rank owns the same
    block of all 6 faces)."""
    if mesh_cfg.face not in (1, 6):
        raise ValueError(f"mesh.face must be 1 or 6, got {mesh_cfg.face}")
    return SubtileLayout(n=npx, h=halo, py=mesh_cfg.y, px=mesh_cfg.x,
                         face_sharded=mesh_cfg.face == 6)


def build_mesh_stepper(model, mesh_cfg, stacked: bool = False):
    """Mesh-aware stepper for the pipeline tasks -> (place, step, unplace,
    description).  The column physics is the model's own `forcing` on the
    held blocks' latitudes.

    mesh_cfg None or one rank: identity place/unplace around model.step.
    stacked: all ranks of the layout in this process on the model's
    device (parallel/comm.StackedGroup).  Otherwise the
    ranks are real: the initialised process group's world size, or the
    visible cards; a layout larger than that runs single-device and says
    so, as the original does."""
    if mesh_cfg is None or mesh_cfg.n_devices <= 1:
        return (lambda s: s), model.step, (lambda s: s), "single-device"
    nd = mesh_cfg.n_devices
    if stacked:
        group = StackedGroup(nd, model.device)
    else:
        available = available_ranks(model.device)
        if available < nd:
            return ((lambda s: s), model.step, (lambda s: s),
                    f"single-device (mesh {nd} devices declared, "
                    f"{available} available)")
        if not torch.distributed.is_initialized():
            raise RuntimeError(
                f"a mesh of {nd} ranks on {available} cards needs one "
                "process per rank (parallel/comm.init_from_env) or stacked "
                "ranks")
        group = ProcessGroup(model.device)
        if group.size != nd:
            raise ValueError(f"mesh of {nd} ranks in a process group of "
                             f"{group.size}")
    cfg = model.config
    lay = layout_from_mesh(mesh_cfg, cfg.npx, cfg.halo)
    step, place, unplace = build_subtile_step(
        model.ctx, lay, group, lats=model.lats, forcing=model.forcing)
    kind = (f"face-sharded (6,{lay.py},{lay.px})" if lay.face_sharded
            else f"faces-local ({lay.py},{lay.px})")
    return place, step, unplace, f"subtile {kind}, {lay.ndevices} devices"
