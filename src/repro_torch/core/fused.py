"""One fused epoch program over device-resident market state, on CUDA graphs.

Counterpart of ``repro.core.fused``.  The staged epoch
(:meth:`repro_torch.core.economy.Economy._settle_epoch`) packs the bid book
in host numpy, runs the clock on the device, and reduces and applies the
settlement on the host again.  This program runs pack → clock → settle →
verify → surplus → apply on the device over tensors that stay there from
epoch to epoch, as the reference's one jitted program does:

* the bid book is assembled on a **fixed slot layout** — slot ``p`` (p < R)
  is pool p's operator lot, slots ``R + 2i`` / ``R + 2i + 1`` are agent i's
  sell and buy rows — with absent rows dead (idx 0, val 0, mask False,
  π = −inf), so every shape is static;
* settlement demand runs through the ``sparse_bid_eval_partials`` kernel:
  once an epoch the present rows are scattered into a blocked book of
  ``settle_blocks`` blocks of ``m_cap = ceil(U_cap / settle_blocks)`` rows,
  row q (the staged row index, the exclusive cumsum of slot presence) at
  ``(q // m_st)·m_cap + q % m_st`` with ``m_st = ceil(U / settle_blocks)``
  and every other row dead — the reference's ``(nb, m_cap, R)`` buffer —
  and the kernel folds each block in the form of a reduce that stands
  alone (``standalone_fold``), as XLA folds that buffer;
* the two float scatter-adds whose order is part of the result (the f32
  supply normaliser and the f64 usage delta) add in operand order through
  the ``ordered_scatter_add`` kernel, as XLA's scatter does on the CPU;
* the program's state (:class:`DeviceMarketState`) is updated in place,
  the twin of the reference's donated buffers.

On the card the program is a set of CUDA graphs, captured once per economy
shape: the pack, one :data:`~repro_torch.core.auction.CHECK_EVERY`-round
chunk of the clock per escalation stage (captured the first time a stage
runs past its first, eager chunk), and settle + verify + surplus + apply.
The host reads the clock's done flag once a chunk and, between escalation
stages, the convergence flag.  On CPU tensors the same stage functions run
eagerly, because the caller asked for the CPU.

Numerics follow the reference's notes: products that feed an add are
rounded on their own (eager torch never contracts), scatter-adds run in
operand order, sorts are stable, and the staged numpy ``np.sum`` over the
surplus contributions is mirrored by :func:`_npsum_f32`.  Bit parity with
the staged path holds for books of ``U_cap = R + 2N ≤`` :data:`PARITY_MAX_ROWS`
rows; beyond, the program is the same market, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops, ref
from ..trace import span
from .auction import (
    ClockConfig,
    ClockLoop,
    _sparse_settle,
    escalate_clock,
    sparse_bundle_costs,
)

# staged constants mirrored verbatim (economy.py / verify defaults)
SELL_DISCOUNT = 1.0 - 0.15
FILL_EMA = 0.5
VERIFY_ATOL = 1e-3
# largest book (rows) for which the surplus fold and the zero-extended
# block sums are bit-identical to the staged path
PARITY_MAX_ROWS = 128


def _exact_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` rounded on its own before any add (the reference guards it
    against XLA's FMA contraction; an eager torch product is never
    contracted)."""
    return a * b


def _npsum_f32(buf: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """numpy ``np.sum``'s pairwise f32 fold over ``buf[:n]``, on the device.

    ``buf`` is a static ``(128,)`` f32 buffer whose first ``n`` (a tensor)
    entries are the summands and whose tail is zero.  Eight lanes fold the
    main body ``n - n % 8`` in row order and combine pairwise, then the
    ≤ 7-element tail adds in sequence — the reference's in-trace mirror,
    expression for expression.
    """
    n = n.long()
    n_main = n - n % 8
    iota = torch.arange(128, device=buf.device)
    masked = torch.where(iota < n_main, buf, 0.0)
    lanes = masked.reshape(16, 8)
    r = lanes[0]
    for c in range(1, 16):
        r = r + lanes[c]
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(7):
        pos = n_main + k
        tail = buf.index_select(0, pos.clamp(0, 127).reshape(1))[0]
        res = res + torch.where(pos < n, tail, 0.0)
    return res


@dataclasses.dataclass
class DeviceMarketState:
    """Device-resident twin of the economy's mutable market state.

    One tensor per field, living on the device across epochs; a fused
    program call updates them in place.  Host mirrors stay authoritative for
    RNG-free bookkeeping (faults, policies, arrivals and departures), and a
    dirty mirror is uploaded again.
    """

    placed: torch.Tensor  # (N,) int64
    home: torch.Tensor  # (N,) int64
    fill_rate: torch.Tensor  # (N,) float64
    usage: torch.Tensor  # (C, T) float64
    belief: torch.Tensor  # (R,) float64

    @classmethod
    def from_host(cls, pop, usage: np.ndarray, belief: np.ndarray, capacity: int | None = None,
                  device: str | torch.device = "cuda"):
        """Upload host mirrors; ``capacity > len(pop)`` pads the per-agent
        fields with inert slots (placed/home −1, fill_rate 1.0) so a
        slack-padded program (``Economy(fused_slack=True)``) keeps one shape
        across bounded population churn.  Inert slots carry ``dropout=True``
        on dispatch, which zeroes their presence."""
        n = int(len(pop.placed))
        cap = n if capacity is None else int(capacity)
        if cap < n:
            raise ValueError(f"device capacity {cap} < population {n}")
        placed, home, fill = pop.placed, pop.home, pop.fill_rate
        if cap > n:
            pad_i = np.full(cap - n, -1, dtype=placed.dtype)
            placed = np.concatenate([placed, pad_i])
            home = np.concatenate([home, pad_i])
            fill = np.concatenate([fill, np.ones(cap - n, fill.dtype)])

        def up(a):  # a copy, never a view of the host mirror
            return torch.from_numpy(np.array(a)).to(device)

        return cls(placed=up(placed), home=up(home), fill_rate=up(fill), usage=up(usage),
                   belief=up(belief))

    def as_tuple(self) -> tuple:
        return (self.placed, self.home, self.fill_rate, self.usage, self.belief)


CONST_FIELDS = ("req", "value", "reloc", "mobility", "budget")
STATE_FIELDS = ("placed", "home", "fill_rate", "usage", "belief")
INPUT_FIELDS = ("u_arb", "perm_keys", "pi_scale", "arb", "margin", "dropout",
                "cap_eff", "free_basis", "tilde_p", "start", "base_cost_flat")


class FusedEpoch:
    """The fused epoch program for one economy shape (:func:`build_fused_epoch`).

    ``program(const, state, inputs)`` takes the immutable population tensors,
    the :class:`DeviceMarketState` (or its tuple) and the epoch's inputs,
    updates the state in place and returns the reference's output dict, key
    for key.  Every input is always passed — overlay defaults are neutral —
    so fault and clean epochs, warm and cold starts, policies on and off all
    run the same stages.
    """

    def __init__(self, *, num_agents: int, num_clusters: int, num_rtypes: int,
                 clock: ClockConfig, clock_retries: int = 0, ration_fallback: bool = False,
                 settle_blocks: int = 8, backend: str | None = None, plain: bool = False):
        if clock.break_ties:
            raise ValueError(
                "fused epochs do not support break_ties: the tie jitter is indexed by global "
                "row position, which the fused slot layout does not preserve for dynamic books"
            )
        self.N, self.C, self.T = int(num_agents), int(num_clusters), int(num_rtypes)
        self.R = self.C * self.T
        self.K = max(self.T, 1)
        self.U_cap = self.R + 2 * self.N
        self.nb = int(settle_blocks)
        self.m_cap = (self.U_cap + self.nb - 1) // self.nb
        self.ration_fallback = bool(ration_fallback)
        # statically pre-escalated configs for the bounded-retry ladder
        self.cfgs = [clock]
        for _ in range(int(clock_retries)):
            self.cfgs.append(escalate_clock(self.cfgs[-1]))
        # plain=True runs every kernel's plain version, eagerly (the ordered
        # scatter's plain version goes through the host, which a graph
        # cannot hold): a run on the card holds the program against it, and
        # nothing on the main path passes it
        self.plain = bool(plain)
        self.kernel_z = ops.fused_epoch_z_fn(backend, self.R, plain=self.plain)
        self._device: torch.device | None = None
        self._in: dict[str, torch.Tensor] = {}  # static copies of const, state, inputs
        self._book: dict[str, torch.Tensor] = {}  # the pack stage's outputs
        self._loops: list[ClockLoop] = []
        self._prices: torch.Tensor | None = None  # the clock's final prices
        self._stages: dict[str, object] = {}  # CUDA graphs, or the eager functions

    # -- the stages ------------------------------------------------------------
    def cache_size(self) -> int:
        """Stages built for this shape: captured CUDA graphs on the card, the
        stage functions on the CPU (the reference's compiled-variant count)."""
        return len(self._stages)

    def _run(self, name: str, fn, warmup: bool = True):
        """Run stage ``name``, built from ``fn`` the first time: replay its
        graph on the card, call it on the CPU."""
        stage = self._stages.get(name)
        if stage is None:
            stage = fn
            if self._device.type == "cuda" and not self.plain:
                with span("fused.capture"):
                    stage = ops.CountedGraph(fn, warmup)
            self._stages[name] = stage
        return stage.replay() if isinstance(stage, ops.CountedGraph) else stage()

    def _bind(self, const, state, inputs) -> None:
        """Copy this call's tensors into the program's static ones (the graphs
        read those addresses); allocate them at the first call."""
        given = dict(zip(CONST_FIELDS, const))
        given.update(zip(STATE_FIELDS, state))
        given.update(zip(INPUT_FIELDS, inputs))
        dev = given["req"].device
        if self._device is None:
            self._device = dev
            self._in = {k: v.clone() for k, v in given.items()}
            self._prices = torch.zeros(self.R, dtype=torch.float32, device=dev)
            self._loops = [None] * len(self.cfgs)
        elif dev != self._device:
            raise ValueError(f"fused program built on {self._device}, called on {dev}")
        for k, v in given.items():
            if v.data_ptr() != self._in[k].data_ptr():
                self._in[k].copy_(v)

    # -- pack: who bids, and what ---------------------------------------------------
    def _pack(self) -> dict[str, torch.Tensor]:
        N, C, T, R, K = self.N, self.C, self.T, self.R, self.K
        g = self._in
        req, value, reloc, mobility, budget = (g[k] for k in CONST_FIELDS)
        placed, home, usage, belief = g["placed"], g["home"], g["usage"], g["belief"]
        u_arb, perm_keys, pi_scale, arb, margin, dropout = (
            g[k] for k in ("u_arb", "perm_keys", "pi_scale", "arb", "margin", "dropout"))
        cap_eff, free_basis, tilde_p = g["cap_eff"], g["free_basis"], g["tilde_p"]
        dev = req.device
        f32, f64, i32 = torch.float32, torch.float64, torch.int32
        t_ar = torch.arange(T, dtype=torch.int64, device=dev)
        c_ar = torch.arange(C, dtype=torch.int64, device=dev)
        neg_inf = float("-inf")

        psi_flat = torch.clamp(usage / torch.clamp_min(cap_eff, 1e-9), 0.0, 1.0).reshape(-1)
        free = torch.clamp_min(free_basis - usage, 0.0).reshape(-1)
        pl_safe = placed.clamp(0, C - 1)
        psi_home0 = psi_flat[pl_safe * T]
        sells = ((placed >= 0) & (arb > 0) & (u_arb < arb) & (psi_home0 > 0.75)) & ~dropout
        wants = ((placed < 0) | sells) & ~dropout

        # believed bundle costs, the staged f64 t-order fold
        p_ct = belief.reshape(C, T)
        believed = torch.zeros((N, C), dtype=f64, device=dev)
        for t in range(T):
            believed = believed + _exact_mul(req[:, t, None], p_ct[None, :, t])

        # reach: stable argsort of the epoch keys, home first, reach-truncated
        perm = torch.argsort(perm_keys, dim=1, stable=True)
        pos = torch.argsort(perm, dim=1, stable=True)  # the inverse permutation
        n_reach = torch.clamp(torch.round(mobility * C).long(), min=1).clamp(max=C)
        key = pos.to(f64)
        key = torch.where(pos >= n_reach[:, None], float("inf"), key)
        at_home = (home >= 0)[:, None] & (c_ar[None, :] == home[:, None])
        key = torch.where(at_home, -1.0, key)
        order = torch.argsort(key, dim=1, stable=True)
        valid = c_ar[None, :] < n_reach[:, None]

        raw_value = value[:, None] - reloc[:, None] * (c_ar[None, :] != home[:, None]).to(f64)
        pi_nc = torch.minimum(torch.minimum(raw_value, believed * (1.0 + margin)[:, None]),
                              budget[:, None])
        pi_nc = pi_nc * pi_scale[:, None]
        bcc = torch.where(valid, order, 0)
        pi_buy = torch.where(valid, torch.gather(pi_nc, 1, bcc).to(f32), neg_inf)
        exp_rev = torch.gather(believed, 1, pl_safe[:, None])[:, 0]
        pi_sell = ((-exp_rev) * SELL_DISCOUNT).to(f32)

        # slot-layout book (U_cap, C, K): operator lots, then sell/buy per agent
        present_op = free > 1e-9
        neg_free32 = (-free).to(f32)
        idx_op = torch.zeros((R, C, K), dtype=i32, device=dev)
        idx_op[:, 0, 0] = torch.where(present_op, torch.arange(R, dtype=i32, device=dev), 0)
        val_op = torch.zeros((R, C, K), dtype=f32, device=dev)
        val_op[:, 0, 0] = torch.where(present_op, neg_free32, 0.0)
        mask_op = torch.zeros((R, C), dtype=torch.bool, device=dev)
        mask_op[:, 0] = present_op
        pi_op = torch.full((R, C), neg_inf, dtype=f32, device=dev)
        pi_op[:, 0] = torch.where(present_op, ((-free) * tilde_p.to(f64)).to(f32), neg_inf)

        sell_idx = (pl_safe[:, None] * T + t_ar[None, :]).to(i32)
        idx_sell = torch.zeros((N, C, K), dtype=i32, device=dev)
        idx_sell[:, 0, :] = torch.where(sells[:, None], sell_idx, 0)
        val_sell = torch.zeros((N, C, K), dtype=f32, device=dev)
        val_sell[:, 0, :] = torch.where(sells[:, None], (-req).to(f32), 0.0)
        mask_sell = torch.zeros((N, C), dtype=torch.bool, device=dev)
        mask_sell[:, 0] = sells
        pi_sell_row = torch.full((N, C), neg_inf, dtype=f32, device=dev)
        pi_sell_row[:, 0] = torch.where(sells, pi_sell, neg_inf)

        live_buy = wants[:, None] & valid
        idx_buy = torch.where(live_buy[:, :, None],
                              (bcc[:, :, None] * T + t_ar[None, None, :]).to(i32), 0)
        val_buy = torch.where(live_buy[:, :, None], req.to(f32)[:, None, :].expand(N, C, K), 0.0)
        pi_buy_row = torch.where(live_buy, pi_buy, neg_inf)

        idx = torch.cat([idx_op, torch.stack([idx_sell, idx_buy], 1).reshape(2 * N, C, K)])
        val = torch.cat([val_op, torch.stack([val_sell, val_buy], 1).reshape(2 * N, C, K)])
        mask = torch.cat([mask_op, torch.stack([mask_sell, live_buy], 1).reshape(2 * N, C)])
        pi = torch.cat([pi_op, torch.stack([pi_sell_row, pi_buy_row], 1).reshape(2 * N, C)])
        present = torch.cat([present_op, torch.stack([sells, wants], 1).reshape(2 * N)])
        q = torch.cumsum(present.long(), 0) - present.long()  # the staged row index
        U = present.sum()

        # supply normaliser: the staged CSR pack's f32 running scatter, in
        # operand order (dead entries would add exact +0.0: dropped); the
        # index stays int32, which the kernel reads in place
        flat_val = val.reshape(-1)
        supply = ops.ordered_scatter_add(
            torch.zeros(R, dtype=f32, device=dev),
            torch.where(flat_val != 0, idx.reshape(-1), -1), flat_val.abs(),
            plain=self.plain)
        supply = torch.clamp_min(supply, 1.0)

        # the blocked settlement book: the staged row q at block q // m_st,
        # offset q % m_st; every other row dead (a sink row takes the
        # absent slots, all identical dead rows)
        nb, m_cap = self.nb, self.m_cap
        rows = nb * m_cap
        m_st = (U + nb - 1) // nb
        dest = torch.where(present, (q // m_st) * m_cap + q % m_st, rows)
        b_idx = torch.zeros((rows + 1, C, K), dtype=i32, device=dev).index_copy_(0, dest, idx)
        b_val = torch.zeros((rows + 1, C, K), dtype=f32, device=dev).index_copy_(0, dest, val)
        b_mask = torch.zeros((rows + 1, C), dtype=torch.bool, device=dev).index_copy_(0, dest, mask)
        b_pi = torch.full((rows + 1, C), neg_inf, dtype=f32, device=dev).index_copy_(0, dest, pi)
        return {
            "idx": idx, "val": val, "mask": mask, "pi": pi, "present": present, "q": q, "U": U,
            "supply": supply, "sells": sells, "wants": wants, "order": order,
            "b_idx": b_idx[:rows], "b_val": b_val[:rows], "b_mask": b_mask[:rows],
            "b_pi": b_pi[:rows], "dest": dest.clamp(max=rows - 1),
        }

    # -- demand ------------------------------------------------------------------
    def _blocked(self, prices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(z, chosen in blocked order) through the partials-mode kernel."""
        b = self._book
        partials, chosen = ops.sparse_bid_eval(
            b["b_idx"], b["b_val"], b["b_mask"], b["b_pi"], prices, self.R, self.nb,
            standalone_fold=True, plain=self.plain)
        return ref.chain_sum(partials), chosen

    def _excess(self, prices: torch.Tensor) -> torch.Tensor:
        b = self._book
        if self.kernel_z is not None:
            return self.kernel_z(b["idx"], b["val"], b["mask"], b["pi"], prices)
        return self._blocked(prices)[0]

    def _clock(self, k: int, start: torch.Tensor) -> None:
        """Escalation stage k from ``start``: its first chunk eager the first
        time, its chunk graph after."""
        loop = self._loops[k]
        if loop is None:
            loop = ClockLoop(self._excess, self.cfgs[k], self._in["base_cost_flat"],
                             self._book["supply"])
            self._loops[k] = loop
        loop.s = self._book["supply"]  # a new tensor each epoch on the CPU
        loop.reset(start)
        name = f"clock{k}"
        if name not in self._stages:
            with span("fused.clock.chunk"):
                loop.chunk()  # the eager first chunk warms the stage up
        while True:
            with span("fused.clock.check"):
                running = loop.running()
            if not running:
                break
            with span("fused.clock.chunk"):
                self._run(name, loop.chunk, warmup=False)

    # -- settle, verify, surplus, apply ----------------------------------------------
    def _settle(self) -> dict[str, torch.Tensor]:
        N, C, R = self.N, self.C, self.R
        b, g = self._book, self._in
        idx, val, mask, pi, present = b["idx"], b["val"], b["mask"], b["pi"], b["present"]
        req, placed, home = g["req"], g["placed"], g["home"]
        fill_rate, usage, belief, cap_eff = g["fill_rate"], g["usage"], g["belief"], g["cap_eff"]
        prices = self._prices
        f32, f64 = torch.float32, torch.float64
        dev = prices.device
        tol = self.cfgs[0].tol

        z, chosen_blk = self._blocked(prices)
        chosen = torch.where(present, chosen_blk.index_select(0, b["dest"]), -1)
        active = chosen >= 0
        converged = (z <= tol).all()
        _, _, payments = _sparse_settle(idx, val, prices, chosen, active, R, exact=True)

        # SYSTEM verify (vector-π checks; dead rows are vacuous)
        costs = sparse_bundle_costs(idx, val, mask, prices)
        surplus_m = torch.where(mask, pi - costs, float("-inf"))
        best = surplus_m.max(dim=1).values
        csel = chosen.long().clamp(min=0)[:, None]
        won_sur = torch.gather(surplus_m, 1, csel)[:, 0]
        scale_v = 1.0 + payments.abs()
        atol = VERIFY_ATOL
        sys_ok = (
            torch.where(active, chosen >= 0, True).all()
            & (z <= atol).all()
            & torch.where(active, won_sur >= -atol * scale_v, True).all()
            & torch.where(active, won_sur >= best - atol * scale_v, True).all()
            & torch.where(~active, best < atol * scale_v, True).all()
            & (prices >= -atol).all()
        )

        # surplus & value of trade: the staged host np.sum, mirrored
        pi_taken = torch.gather(pi, 1, csel)[:, 0]
        c_surplus = torch.where(active, pi_taken - payments, 0.0)
        c_trade = torch.where(active & (payments > 0), payments, 0.0)
        if self.U_cap <= PARITY_MAX_ROWS:
            slot = torch.where(present, b["q"], PARITY_MAX_ROWS)

            def npsum(x):
                buf = torch.zeros(PARITY_MAX_ROWS + 1, dtype=f32, device=dev)
                buf.index_copy_(0, slot, x)  # absent slots land on the dropped last one
                return _npsum_f32(buf[:PARITY_MAX_ROWS], b["U"])

            surplus, trade = npsum(c_surplus), npsum(c_trade)
        else:  # beyond the parity regime: one fold (float-close)
            surplus = ref.block_fold(c_surplus, vectorized=False)
            trade = ref.block_fold(c_trade, vectorized=False)

        # apply: usage commit, placements, fills, beliefs
        agent_act = active[R:].reshape(N, 2)
        won_sell, won_buy = agent_act[:, 0], agent_act[:, 1]
        pay_agent = payments[R:].reshape(N, 2)
        pi_agent = pi_taken[R:].reshape(N, 2)
        chosen_buy = chosen[R:].reshape(N, 2)[:, 1]
        bc_sel = torch.gather(b["order"], 1, chosen_buy.long().clamp(min=0)[:, None])[:, 0]

        def scatter(target, rows_at, source):  # out-of-range C: dropped
            return ops.ordered_scatter_add(target, rows_at, source, plain=self.plain)

        oob = C
        old = torch.where(won_sell, -1, placed)
        move = won_buy & (old >= 0) & (old != bc_sel)
        # XLA rewrites usage + (the delta's scatters from zeros) into the
        # same scatters continuing from usage; with rationing the sell pass
        # is shared, so it stays a delta added to usage and the later passes
        # continue from that sum.  Passes in a row are one scatter of their
        # rows in pass order: the same sums in the same order.
        sell_at = torch.where(won_sell, placed, oob)
        buy_at = torch.where(won_buy, bc_sel, oob)
        move_at = torch.where(move, old, oob)
        if self.ration_fallback:
            base = usage + scatter(torch.zeros((C, self.T), dtype=f64, device=dev), sell_at, -req)
            released = scatter(base.clone(), move_at, -req)
            room = torch.clamp_min(cap_eff - torch.clamp_min(released, 0.0), 0.0)
            claim = scatter(torch.zeros((C, self.T), dtype=f64, device=dev), buy_at, req)
            frac = torch.where(claim > 1e-12,
                               torch.clamp(room / torch.clamp_min(claim, 1e-12), max=1.0), 1.0)
            per = torch.where(req > 0, frac[bc_sel], 1.0)
            scale_r = per.min(dim=1).values
            ration_on = ~converged  # staged: ration_fallback and not converged
            buy_scale = torch.where(ration_on & won_buy, scale_r, 1.0)
            rationed = torch.where(ration_on, (won_buy & (scale_r < 1.0 - 1e-12)).sum(), 0)
            u = scatter(base, torch.cat([buy_at, move_at]),
                        torch.cat([_exact_mul(buy_scale[:, None], req), -req]))
        else:
            buy_scale = torch.ones(N, dtype=f64, device=dev)
            rationed = torch.zeros((), dtype=torch.int64, device=dev)
            u = scatter(usage.clone(), torch.cat([sell_at, buy_at, move_at]),
                        torch.cat([-req, req, -req]))
        usage_new = torch.minimum(torch.clamp_min(u, 0.0), cap_eff)

        placed_new = torch.where(won_buy, bc_sel, torch.where(won_sell, -1, placed))
        home_new = torch.where(won_buy, bc_sel, home)
        fill_new = torch.where(
            b["wants"], (1.0 - FILL_EMA) * fill_rate + FILL_EMA * won_buy.to(f64), fill_rate)
        belief_new = 0.25 * belief + (0.75 * prices).to(f64)
        return {
            "converged": converged, "system_ok": sys_ok, "surplus": surplus,
            "value_of_trade": trade, "sells": b["sells"], "wants": b["wants"],
            "won_sell": won_sell, "won_buy": won_buy,
            "pay_sell": pay_agent[:, 0], "pay_buy": pay_agent[:, 1],
            "pi_sell": pi_agent[:, 0], "pi_buy": pi_agent[:, 1],
            "buy_cluster": bc_sel, "buy_scale": buy_scale, "rationed_rows": rationed,
            "placed_new": placed_new, "home_new": home_new, "fill_new": fill_new,
            "usage_new": usage_new, "belief_new": belief_new,
        }

    # -- one epoch ---------------------------------------------------------------
    def __call__(self, const, state, inputs) -> dict:
        state_t = state.as_tuple() if isinstance(state, DeviceMarketState) else tuple(state)
        self._bind(const, state_t, inputs)
        with span("fused.pack"):
            self._book = self._run("pack", self._pack)

        # clock + bounded-retry escalation ladder: the host reads the
        # convergence flag between stages
        with span("fused.clock"):
            self._clock(0, self._in["start"])
        prices, rounds = self._loops[0].prices(), self._loops[0].t.clone()
        esc = 0
        for k in range(1, len(self.cfgs)):
            with span("fused.clock.check"):
                settled = bool((self._excess(prices) <= self.cfgs[0].tol).all())
            if settled:
                break
            esc += 1
            with span("fused.clock"):
                self._clock(k, prices)
            prices, rounds = self._loops[k].prices(), self._loops[k].t.clone()
        self._prices.copy_(prices)

        with span("fused.settle"):
            out = self._run("settle", self._settle)
        out = {k: v.clone() for k, v in out.items()}
        for name, new in zip(STATE_FIELDS, ("placed_new", "home_new", "fill_new",
                                            "usage_new", "belief_new")):
            state_t[STATE_FIELDS.index(name)].copy_(out[new])
        out.update(prices=self._prices.clone(), rounds=rounds, escalations=esc)
        return out


def build_fused_epoch(*, num_agents: int, num_clusters: int, num_rtypes: int,
                      clock: ClockConfig, clock_retries: int = 0, ration_fallback: bool = False,
                      settle_blocks: int = 8, backend: str | None = None,
                      plain: bool = False) -> FusedEpoch:
    """The fused epoch program for a fixed economy shape (see
    :class:`FusedEpoch`).  ``backend``: ``None`` keeps the exact blocked fold
    in the price loop; ``"z"`` runs the loop's z through the z-mode kernel
    (float-close trajectory; selection, settlement and the convergence check
    stay exact).  ``plain``: every kernel's plain version, no graphs."""
    return FusedEpoch(num_agents=num_agents, num_clusters=num_clusters, num_rtypes=num_rtypes,
                      clock=clock, clock_retries=clock_retries,
                      ration_fallback=ration_fallback, settle_blocks=settle_blocks,
                      backend=backend, plain=plain)


def fused_program_cache_size(fn: FusedEpoch) -> int:
    """Stages a fused program has built (the recompile guard)."""
    return fn.cache_size()
