"""Node-sharded training over ``torch.distributed`` (counterpart of
``tpu_sage/dist/train.py``).

Each rank owns a contiguous node range (adjacency rows, degrees, features,
targets) and the slice of every batch drawn from its range. One step, on
every rank:

1. ``batch_per_shard`` root ids from the rank's fold group, by a per-epoch
   permutation walked without replacement (``epoch_perm``/``perm_batch``);
2. level by level, the frontier's adjacency ‖ degree rows by halo exchange
   and a uniform column pick (``sample_level_distributed``; on CSR shards
   with the exact mode, the pick at the owner);
3. every level's feature rows by halo exchange (``gather_level_feats``):
   under ``mean``/``gcn`` with the identity prep the deepest level arrives
   as per-root f32 means, pre-reduced by its owners;
4. the network on the gathered rows (``GSSupervised.forward_gathered``),
   the loss weighted by the rank's share of the fold,
   ``w / max(Σ_ranks w, 1e-12)``, backward, one ``all_reduce(SUM)`` of one
   flattened gradient buffer (the loss and the overflow count ride in it),
   and the same Adam update on every rank, so the replicas stay equal.

Over a 2-D ``(host, chip)`` layout (``mesh.Layout2D``) the ``hier2d`` mode
reduces each exchange within the host before across hosts
(``halo.dist_gather_2d``); the shard of rank ``host·n_chips + chip`` is the
same as on the flat layout, so batches, losses and checkpoints agree.

The JAX package compiles this as one ``shard_map`` program per step or per
scanned epoch; here each rank runs it eagerly and its kernels are the port's
(``gather_rows`` for every owner's answers, ``gather_fanout_mean_owned`` for
the pre-reduced level, ``select_hop`` for the requester's column pick with
its arithmetic and degree-0 self-loop, one launch a hop, ``mean_project``
inside the model).

Randomness cannot match ``jax.random``: the epoch permutation and the
sampling uniforms come from ``torch.Generator``s seeded from ``(seed, epoch,
rank)`` (``rng_seed``), so a resumed run replays the epochs it redoes, on
any shard count.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_sage_torch import overrides
from tpu_sage_torch.dist.halo import (CSRPairRows, all_gather_rows, dist_gather,
                                      dist_gather_2d, dist_gather_bucketed,
                                      dist_gather_fanout_mean, dist_gather_ring,
                                      dist_gather_ring_fanout_mean,
                                      dist_gather_ring_pipelined,
                                      dist_sample_csr_owner_select)
from tpu_sage_torch.dist.mesh import Layout2D, host_layout, layout_2d, rank, world
from tpu_sage_torch.dist.partition import (shard_fold, shard_fold_masked, shard_graph,
                                           shard_graph_csr)
from tpu_sage_torch.graph.graph_data import GraphStore
from tpu_sage_torch.kernels.gather_mean import reciprocal
from tpu_sage_torch.kernels.select import select_hop
from tpu_sage_torch.nn.model import GSSupervised
from tpu_sage_torch.train.checkpoint import BestTracker, maybe_checkpoint, resume_state
from tpu_sage_torch.train.losses import loss_lookup
from tpu_sage_torch.train.trainer import (COMPUTE_DTYPES, TrainConfig, TrainState,
                                          build_model, build_optimizer, fold_metric_np,
                                          make_schedule)

HALO_MODES = ("auto", "measured", "exact", "ring", "pipelined", "bucketed", "hier2d")
# streams of rng_seed: the epoch permutation, the training uniforms, the eval's
PERM, SAMPLE, EVAL = 77_003, 1, 2


def rng_seed(seed: int, stream: int, epoch: int, shard: int) -> int:
    """A generator seed for ``(seed, stream, epoch, shard)``, mixed by numpy's
    ``SeedSequence`` so nearby tuples give unrelated streams."""
    ss = np.random.SeedSequence([seed & 0xFFFFFFFF, stream, epoch, shard])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def resolve_halo_mode(mode: str, n_shards: int) -> str:
    """The config's halo mode as a concrete exchange: ``auto`` is ``exact``
    (the JAX package's measured default at every shard count); explicit
    modes pass through (``hier2d`` needs a 2-D layout, which the trainer
    checks); ``measured`` is resolved by ``from_store`` and
    ``fit_partitioned``."""
    if mode not in HALO_MODES:
        raise ValueError(f"unknown halo mode {mode!r}; valid choices: {', '.join(HALO_MODES)}")
    if mode == "measured":
        raise ValueError(
            "halo='measured' is resolved by PartitionedTrainer.from_store / "
            "fit_partitioned (timing the candidates needs the sharded graph); build "
            "through from_store, or pass a concrete mode")
    return "exact" if mode == "auto" else mode


def halo_candidates(n_shards: int, two_d: bool = False) -> List[str]:
    """The modes ``halo='measured'`` races: exact, ring and pipelined, never
    bucketed (its overflow changes values); on a 2-D ``(host, chip)``
    layout exact and hier2d (a ring is defined on one axis); at one shard
    only exact."""
    if n_shards == 1:
        return ["exact"]
    return ["exact", "hier2d"] if two_d else ["exact", "ring", "pipelined"]


def resolve_layout(config: TrainConfig, layout: Optional[Layout2D]) -> Optional[Layout2D]:
    """``halo='hier2d'`` with no layout given builds the group's own
    ``(host, chip)`` layout (``mesh.host_layout``: one row per host), as the
    JAX package's ``resolve_mesh_axis`` builds one host row per process;
    otherwise the given layout (None: flat)."""
    if layout is None and config.halo == "hier2d":
        return layout_2d(*host_layout())
    return layout


def resolve_measure_steps(n_steps: Optional[int], device: torch.device) -> int:
    """``halo_measure_steps=None``: 20 racing steps on the CPU, 100 on the card."""
    if n_steps is not None:
        return int(n_steps)
    return 20 if device.type == "cpu" else 100


def measure_halo_mode(make_trainer: Callable, run_epoch: Callable, candidates: Sequence[str],
                      n_steps: int, repeats: int = 2):
    """Race the candidates' real epochs and return ``(winner, {mode:
    ms_per_step}, fallback_reason_or_None)``.

    Each candidate's trainer (``make_trainer(mode)``, with a fresh state)
    runs one warm-up epoch of ``n_steps`` steps, then ``repeats`` timed ones;
    its time is the best. A margin between the best two within their summed
    repeat spreads abstains to ``exact`` when exact is itself within noise
    of the best. Every rank races (the epochs are collective) and takes rank
    0's pick, broadcast, so all run the same exchange."""
    if len(candidates) == 1:
        return candidates[0], {}, None
    timings, spreads = {}, {}
    device = None
    for mode in candidates:
        tr = make_trainer(mode)
        state = tr.init_state()
        device = tr.device
        state, m = run_epoch(tr, state, n_steps)
        float(m["loss"])
        reps = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            state, m = run_epoch(tr, state, n_steps)
            float(m["loss"])
            reps.append(1e3 * (time.perf_counter() - t0) / n_steps)
        timings[mode] = round(min(reps), 4)
        spreads[mode] = round(max(reps) - min(reps), 4)
    ranked = sorted(timings, key=timings.get)
    winner = ranked[0]
    margin = timings[ranked[1]] - timings[ranked[0]]
    noise = spreads[ranked[0]] + spreads[ranked[1]]
    fallback = None
    if margin <= noise and "exact" in candidates:
        exact_gap = timings["exact"] - timings[ranked[0]]
        exact_noise = spreads["exact"] + spreads[ranked[0]]
        if exact_gap <= exact_noise:
            fallback = (f"margin {round(margin, 4)} ms/step within repeat noise "
                        f"{round(noise, 4)} — using the auto default")
            winner = "exact"
        else:
            fallback = (f"margin {round(margin, 4)} ms/step within repeat noise "
                        f"{round(noise, 4)}; exact is {round(exact_gap, 4)} ms/step slower "
                        f"than the best (beyond its noise {round(exact_noise, 4)}) — keeping "
                        f"the measured best")
    order = sorted(candidates)
    pick = torch.tensor([order.index(winner)], dtype=torch.int64, device=device)
    dist.broadcast(pick, 0)
    return order[int(pick.item())], timings, fallback


def _zero(ids: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=ids.device)


def _mean_rows(rows: torch.Tensor, fanout: int) -> torch.Tensor:
    """f32 mean of ``rows (R·F, d)`` per root, summed in order from zero and
    multiplied by ``fl32(1/F)``: the jitted reference's ``jnp.mean``."""
    x = rows.float().view(-1, fanout, rows.shape[-1])
    acc = torch.zeros_like(x[:, 0])
    for j in range(fanout):
        acc = acc + x[:, j]
    return acc * reciprocal(fanout)


def make_gather(mode: str, n_shards: int, capacity_factor: float,
                layout: Optional[Layout2D] = None):
    """The halo exchange for one level: ``fn(table, ids) -> (rows,
    n_overflow)``, the overflow 0 but for ``bucketed`` (``capacity =
    max(1, int(capacity_factor · q / n_shards))``); ``hier2d`` over
    ``layout``. The reference's ``halo_chunks`` (a TPU descriptor-stream knob
    that changes no value) has no counterpart: the port does not split the
    exchange."""
    if mode == "exact":
        return lambda table, ids: (dist_gather(table, ids), _zero(ids))
    if mode in ("ring", "pipelined"):
        return lambda table, ids: (dist_gather_ring(table, ids), _zero(ids))
    if mode == "hier2d":
        return lambda table, ids: (dist_gather_2d(table, ids, layout), _zero(ids))
    if mode != "bucketed":
        raise ValueError(f"no flat halo exchange named {mode!r}")

    def bucketed(table, ids):
        capacity = max(1, int(capacity_factor * ids.shape[0] / n_shards))
        return dist_gather_bucketed(table, ids, capacity)

    return bucketed


def make_gather_last(mode: str, n_shards: int, capacity_factor: float = 2.0,
                     layout: Optional[Layout2D] = None):
    """The deepest level's exchange pre-reduced to per-root f32 means:
    ``fn(table, ids, fanout) -> (means, n_overflow)``. Bucketed routing
    answers per query, so it gathers the rows and means them at the
    requester. The consumer must be told (``last_reduced_fanout``)."""
    if mode == "exact":
        return lambda table, ids, fanout: (dist_gather_fanout_mean(table, ids, fanout),
                                           _zero(ids))
    if mode in ("ring", "pipelined"):
        return lambda table, ids, fanout: (dist_gather_ring_fanout_mean(table, ids, fanout),
                                           _zero(ids))
    if mode == "hier2d":
        return lambda table, ids, fanout: (dist_gather_2d(table, ids, layout, fanout),
                                           _zero(ids))
    gather = make_gather(mode, n_shards, capacity_factor)

    def bucketed_mean(table, ids, fanout):
        rows, ovf = gather(table, ids)
        return _mean_rows(rows, fanout), ovf

    return bucketed_mean


def make_gather_levels(mode: str, n_shards: int):
    """``pipelined``: ``fn(table, levels, last_fanout) -> (rows_list,
    n_overflow)``, every level in one hop-major ring; None for the modes
    that exchange level by level."""
    if mode != "pipelined":
        return None
    return lambda table, levels, last_fanout: (
        dist_gather_ring_pipelined(table, levels, last_fanout=last_fanout), _zero(levels[0]))


def gather_level_feats(gather, gather_last, feats, levels, fanouts, dq, gather_levels=None):
    """Every level's feature rows by halo exchange, each through ``dq``
    (the requester's dequantize, or the cast of a pre-reduced mean to the
    table's dtype). With ``gather_last`` the deepest level arrives as
    per-root means. Returns ``(level_rows, n_overflow)``."""
    if gather_levels is not None:
        lf = fanouts[-1] if gather_last is not None else None
        rows_list, ovf = gather_levels(feats, levels, lf)
        return [dq(r) for r in rows_list], ovf
    out, ovf = [], _zero(levels[0])
    for ids in (levels if gather_last is None else levels[:-1]):
        rows, o = gather(feats, ids)
        out.append(dq(rows))
        ovf = ovf + o
    if gather_last is not None:
        rows, o = gather_last(feats, levels[-1], fanouts[-1])
        out.append(dq(rows))
        ovf = ovf + o
    return out, ovf


def all_reduce_grads(params: List[torch.Tensor], extra: Sequence[torch.Tensor],
                     divisor: int = 1, group=None) -> torch.Tensor:
    """Sum every parameter's gradient over the ranks of ``group`` (default:
    all) in place, divided by ``divisor``, with the ``extra`` scalars riding
    in the same buffer: one ``all_reduce`` per step. A missing gradient
    counts as zeros (optax's for a parameter the loss does not reach).
    Returns the reduced extras."""
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [e.detach().float().reshape(1) for e in extra])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat /= divisor
    at = 0
    for p in params:
        g = flat[at:at + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        at += p.numel()
    return flat[at:]


def epoch_perm(seed: int, epoch: int, shard: int, L: int, count: float,
               device: torch.device) -> torch.Tensor:
    """A random permutation of the shard's first ``count`` real fold slots
    (then the wrapped ones), fixed for the epoch: ``(L,)`` int64."""
    gen = torch.Generator(device=device).manual_seed(rng_seed(seed, PERM, epoch, shard))
    r = torch.rand(L, generator=gen, device=device)
    r = torch.where(torch.arange(L, device=device) < count, r, float("inf"))
    return torch.argsort(r, stable=True)


def perm_batch(perm: torch.Tensor, fold_row: torch.Tensor, count: float, t: int,
               bps: int) -> torch.Tensor:
    """Slots ``[t·bps, t·bps + bps) mod count`` of the epoch permutation:
    without replacement until the group is used up, never the wrapped tail."""
    n = max(int(count), 1)
    slot = (t * bps + torch.arange(bps, device=perm.device)) % n
    return fold_row[perm[slot]]


def epoch_batch_ids(seed: int, step: int, fold_row: torch.Tensor, count: float, bps: int,
                    steps_per_epoch: int, shard: int) -> torch.Tensor:
    """``epoch_perm`` + ``perm_batch`` for global step ``step``."""
    epoch, t = divmod(step, steps_per_epoch)
    perm = epoch_perm(seed, epoch, shard, fold_row.shape[0], count, fold_row.device)
    return perm_batch(perm, fold_row, count, t, bps)


def sample_level_distributed(
    adj_deg, ids: torch.Tensor, fanout: int, gather=None, pair_window: int = 0,
    owner_select=None, generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sampling hop with the frontier's rows fetched by halo exchange:
    ``adj_deg`` is the rank's ``(m, max_degree + 1)`` adjacency ‖ degree
    table, or a ``CSRPairRows`` view with ``pair_window`` set. ``u (q,
    fanout)`` injects the uniforms (else drawn from ``generator``); the
    column is ``min(trunc(u·deg), deg − 1)`` and degree-0 rows self-loop,
    as on one device. ``owner_select(ids, u)`` moves the pick to the owner.
    Returns ``(neighbor ids (q·fanout,), n_overflow)``."""
    ids = ids.to(torch.int32).contiguous()
    if u is None:
        u = torch.rand((ids.shape[0], fanout), generator=generator, device=ids.device)
    if owner_select is not None:
        out = owner_select(ids, u)
        vals, r_deg = out[:, :-1], out[:, -1]
        return torch.where(r_deg[:, None] == 0, ids[:, None], vals).reshape(-1), _zero(ids)
    if gather is None:
        gather = make_gather("exact", world(), 2.0)
    rows, ovf = gather(adj_deg, ids)
    if pair_window:
        r_adj = rows[:, :2 * pair_window]
        shift = rows[:, 2 * pair_window]
        r_deg = rows[:, 2 * pair_window + 1]
    else:
        r_adj, r_deg, shift = rows[:, :-1], rows[:, -1], None
    nbr = select_hop(r_adj, r_deg, u.contiguous(), shift=shift, ids=ids)
    return nbr.reshape(-1), ovf


class PartitionedTrainer:
    """Trainer over this rank's shard of a node-sharded graph; the sibling of
    ``train/trainer.py::Trainer`` with the same config surface.

    Build it with ``from_store``, inside a process group (``dist.mesh``).
    ``layout``: a 2-D ``(host, chip)`` layout of the group (``halo='hier2d'``
    needs one); the shards and batches are those of the flat layout."""

    def __init__(self, model: GSSupervised, config: TrainConfig, shard_size: int,
                 steps_per_epoch: int, device: torch.device, task: str = "classification",
                 csr_window: int = 0, layout: Optional[Layout2D] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.config = config
        self.shard_size = shard_size
        self.device = torch.device(device)
        self.task = task
        self.csr_window = csr_window
        self.n_shards = world()
        self.loss_fn = loss_lookup[task]
        self.steps_per_epoch = steps_per_epoch
        self._lr_fn = make_schedule(config, steps_per_epoch)
        self.batch_per_shard = max(1, config.batch_size // self.n_shards)
        self.halo_mode = resolve_halo_mode(config.halo, self.n_shards)
        self.layout = layout
        if self.halo_mode == "hier2d" and layout is None:
            raise ValueError(
                "halo='hier2d' routes within the host before across hosts and needs a 2-D "
                "(host, chip) layout; got the flat one: pass layout=mesh.layout_2d(n_hosts, "
                "n_chips), or let fit_partitioned build the group's own")
        # CSR shards with the exact exchange: the column pick moves to the
        # owner, which answers fanout + 1 ints per query instead of 2w + 2
        self.owner_select_on = (csr_window > 0 and self.halo_mode == "exact"
                                and config.csr_owner_select)
        cf = config.halo_capacity_factor
        self.gather = make_gather(self.halo_mode, self.n_shards, cf, layout)
        self.gather_last = (
            make_gather_last(self.halo_mode, self.n_shards, cf, layout)
            if model.aggregator_class in ("mean", "gcn") and model.prep_class == "identity"
            and overrides.fuse_last(config.fuse_last) != "off" else None)
        self.gather_levels = make_gather_levels(self.halo_mode, self.n_shards)
        self.halo_timings = None
        self.halo_fallback = None
        self._views = {}  # id(graph) -> (graph, adjacency view)
        self._perm = (None, None)  # (epoch, fold row's permutation)
        self._sample_epoch = None  # the epoch the state's generator is seeded for
        self._eval_graph = None  # ((store, kind), (graph, m))
        self._eval_dense_only = False
        self._train_store = None
        self._train_feats = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_store(cls, store: GraphStore, config: TrainConfig, device: str | torch.device,
                   csr: bool = False, layout: Optional[Layout2D] = None):
        """This rank's training shard, fold row and trainer from the host
        store every rank holds. ``halo='measured'`` races the candidates here.
        Returns ``(trainer, graph, fold_ids, fold_w)``: the shard, this
        rank's ``(L,)`` fold slots on the device, every rank's true fold
        count (host, f32)."""
        device = torch.device(device)
        graph, fold_ids, fold_w, m, spe = cls._sharded_inputs(store, config, device, csr)
        model = build_model(config, store.n_nodes, store.n_classes, store.feat_dim)
        kw = dict(task=store.task, csr_window=getattr(graph, "window", 0), layout=layout)
        config, raced = cls._race(config, lambda c: cls(model, c, m, spe, device, **kw), graph,
                                  fold_ids, fold_w, device, layout)
        trainer = cls(model, config, m, spe, device, **kw)
        trainer._adopt(store, graph, raced)
        return trainer, graph, fold_ids, fold_w

    @staticmethod
    def _sharded_inputs(store: GraphStore, config: TrainConfig, device: torch.device,
                        csr: bool):
        """``(graph, fold_ids, fold_w, shard_size, steps_per_epoch)``."""
        cd = COMPUTE_DTYPES[config.compute_dtype]
        graph, m = (shard_graph_csr if csr else shard_graph)(
            store, train=True, device=device, feat_dtype=None if cd == torch.float32 else cd,
            quantize=config.feature_int8)
        fold, fold_w = shard_fold(store.folds["train"], world(), m)
        fold_ids = torch.as_tensor(fold[rank()], dtype=torch.int32, device=device)
        steps_per_epoch = max(1, len(store.folds["train"]) // config.batch_size)
        return graph, fold_ids, fold_w, m, steps_per_epoch

    @staticmethod
    def _race(config, make, graph, fold_ids, fold_w, device, layout):
        """``halo='measured'``: the config with the winner of the real epochs
        of the trainers ``make(config)`` builds (so each trainer class races
        its own objective), and ``(timings, fallback)``; any other mode as it
        is, with ``(None, None)``."""
        if config.halo != "measured":
            return config, (None, None)
        winner, timings, fallback = measure_halo_mode(
            lambda mode: make(config.replace(halo=mode)),
            lambda tr, st, n: tr.train_epoch(st, graph, fold_ids, fold_w, n_steps=n),
            halo_candidates(world(), layout is not None),
            resolve_measure_steps(config.halo_measure_steps, device))
        return config.replace(halo=winner), (timings, fallback)

    def _adopt(self, store: GraphStore, graph, raced) -> None:
        """Record the race and the training store, whose feature shard the
        evaluation's full-graph shard adopts instead of uploading again."""
        self.halo_timings, self.halo_fallback = raced
        self._train_store = store
        self._train_feats = (graph.feats, graph.feat_scale)

    def init_state(self) -> TrainState:
        """Fresh parameters from a CPU generator seeded with the config's
        seed (the same on every rank), the optimizer, a sampling generator
        on the rank's device (seeded per epoch at step time)."""
        self.model.reset_parameters(torch.Generator().manual_seed(self.config.seed))
        self.model.to(self.device)
        opt = build_optimizer(self.config, self.model.parameters(), self._lr_fn(0))
        self._sample_epoch = None
        return TrainState(model=self.model, optimizer=opt, step=0,
                          generator=torch.Generator(device=self.device))

    # -- the step ------------------------------------------------------------

    def adjacency_view(self, graph):
        """The rank's exchanged adjacency table, built once per graph: dense
        ``adj ‖ deg`` rows, or the CSR pair view."""
        hit = self._views.get(id(graph))
        if hit is None or hit[0] is not graph:
            if hasattr(graph, "indptr"):
                view = CSRPairRows(graph.indptr, graph.indices, graph.degrees, graph.window)
            else:
                view = torch.cat([graph.adj, graph.degrees[:, None]], dim=1)
            hit = self._views[id(graph)] = (graph, view)
        return hit[1]

    def _owner_select(self, graph):
        if not (self.owner_select_on and hasattr(graph, "indptr")):
            return None
        return lambda ids, u: dist_sample_csr_owner_select(
            graph.indptr, graph.indices, graph.degrees, graph.window, ids, u)

    def sample_levels(self, graph, ids: torch.Tensor, fanouts: Sequence[int],
                      generator: torch.Generator):
        """The tree's levels from roots ``ids`` by distributed hops. Returns
        ``(levels, n_overflow)``."""
        view = self.adjacency_view(graph)
        window = getattr(graph, "window", 0)
        os_fn = self._owner_select(graph)
        levels, ovf = [ids.to(torch.int32)], _zero(ids)
        for f in fanouts:
            nbr, o = sample_level_distributed(
                view, levels[-1], f, self.gather, pair_window=window, owner_select=os_fn,
                generator=generator)
            levels.append(nbr)
            ovf = ovf + o
        return levels, ovf

    def forward_levels(self, graph, levels: List[torch.Tensor], head: bool = True):
        """Logits (``head``; else the embeddings) of the roots ``levels[0]``
        from the exchanged feature rows. Returns ``(out, n_overflow)``."""
        feats, scale = graph.feats, graph.feat_scale
        if scale is None:
            dq = lambda rows: rows.to(feats.dtype)  # noqa: E731
        else:
            dq = lambda rows: rows.to(scale.dtype) * scale  # noqa: E731
        fanouts = [levels[i + 1].shape[0] // levels[i].shape[0] for i in range(len(levels) - 1)]
        level_feats, ovf = gather_level_feats(self.gather, self.gather_last, feats, levels,
                                              fanouts, dq, gather_levels=self.gather_levels)
        lrf = fanouts[-1] if self.gather_last is not None else None
        fn = self.model.forward_gathered if head else self.model.encode_gathered
        return fn(levels, level_feats, lrf), ovf

    def _seed_epoch(self, state: TrainState, epoch: int) -> None:
        """Seed the epoch's sampling streams: the tree's."""
        state.generator.manual_seed(rng_seed(self.config.seed, SAMPLE, epoch, rank()))

    def _batch_ids(self, state: TrainState, fold_ids: torch.Tensor, count: float) -> torch.Tensor:
        epoch, t = divmod(state.step, self.steps_per_epoch)
        if self._perm[0] != epoch or self._perm[1].shape[0] != fold_ids.shape[0]:
            self._perm = (epoch, epoch_perm(self.config.seed, epoch, rank(), fold_ids.shape[0],
                                            count, fold_ids.device))
        if self._sample_epoch != epoch:
            self._seed_epoch(state, epoch)
            self._sample_epoch = epoch
        return perm_batch(self._perm[1], fold_ids, count, t, self.batch_per_shard)

    def train_step(self, state: TrainState, graph, fold_ids: torch.Tensor, fold_w: np.ndarray,
                   levels: Optional[List[torch.Tensor]] = None):
        """One step on every rank. ``levels`` injects this rank's tree (its
        roots must be its own nodes; parity tests). Returns ``(state,
        {"loss", "halo_overflow", "lr"})``, the loss and overflow summed over
        the ranks."""
        w = float(fold_w[rank()])
        total = float(np.sum(fold_w))
        lr = self._lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        if levels is None:
            ids = self._batch_ids(state, fold_ids, w)
            with torch.no_grad():
                levels, ovf = self.sample_levels(graph, ids, self.model.fanouts(train=True),
                                                 state.generator)
        else:
            ovf = _zero(levels[0])
        tgt = graph.targets[(levels[0] - rank() * self.shard_size).long()]
        state.optimizer.zero_grad(set_to_none=True)
        logits, o = self.forward_levels(graph, levels)
        scale = torch.tensor(w, dtype=torch.float32) / torch.tensor(max(total, 1e-12),
                                                                     dtype=torch.float32)
        loss_s = self.loss_fn(logits, tgt) * scale.item()
        loss_s.backward()
        loss, overflow = all_reduce_grads(list(self.model.parameters()), (loss_s, ovf + o))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "halo_overflow": overflow, "lr": lr}

    def train_epoch(self, state: TrainState, graph, fold_ids: torch.Tensor, fold_w: np.ndarray,
                    n_steps: Optional[int] = None):
        """``n_steps`` (default: ``steps_per_epoch``) steps; returns the
        state and ``{"loss": mean, "halo_overflow": sum, "lr": last}``."""
        losses, ovfs, lr = [], [], self._lr_fn(state.step)
        for _ in range(int(n_steps or self.steps_per_epoch)):
            state, m = self.train_step(state, graph, fold_ids, fold_w)
            losses.append(m["loss"])
            ovfs.append(m["halo_overflow"])
            lr = m["lr"]
        return state, {"loss": torch.stack(losses).mean(),
                       "halo_overflow": torch.stack(ovfs).sum(), "lr": lr}

    # -- evaluation ----------------------------------------------------------

    def _full_graph_shard(self, store: GraphStore):
        """This rank's shard of the full graph, cached per store (held, so
        the identity stays meaningful) and storage kind; the training
        shard's feature rows are adopted when the store is the training
        one."""
        want_dense = self.csr_window == 0 or self._eval_dense_only
        key = (store, "dense" if want_dense else "csr")
        if self._eval_graph is None or self._eval_graph[0][0] is not store \
                or self._eval_graph[0][1] != key[1]:
            cd = COMPUTE_DTYPES[self.config.compute_dtype]
            reuse = self._train_feats if self._train_store is store else None
            shard = shard_graph if want_dense else shard_graph_csr
            self._eval_graph = (key, shard(
                store, train=False, device=self.device,
                feat_dtype=None if cd == torch.float32 else cd,
                quantize=self.config.feature_int8, reuse_feats=reuse))
        return self._eval_graph[1]

    @torch.no_grad()
    def eval_stats(self, state: TrainState, store: GraphStore, fold: str = "val",
                   seed: int = 0) -> torch.Tensor:
        """The sampled evaluation's sums over every rank's fold nodes, each
        counted exactly once (masked padding): ``(correct, count, 0)`` for
        classification, ``(tp, fp, fn)`` for multilabel, ``(squared error,
        absolute error, count)`` for regression."""
        graph, m = self._full_graph_shard(store)
        bps = self.batch_per_shard
        ids, mask = shard_fold_masked(store.folds[fold], self.n_shards, m, pad_to_multiple=bps)
        me = rank()
        ids = torch.as_tensor(ids[me], dtype=torch.int32, device=self.device).view(-1, bps)
        mask = torch.as_tensor(mask[me], device=self.device).view(-1, bps)
        gen = torch.Generator(device=self.device).manual_seed(rng_seed(seed, EVAL, 0, me))
        fanouts = self.model.fanouts(train=False)
        stats = torch.zeros(3, dtype=torch.float32, device=self.device)
        for cids, cmask in zip(ids, mask):
            levels, _ = self.sample_levels(graph, cids, fanouts, gen)
            logits, _ = self.forward_levels(graph, levels)
            tgt = graph.targets[(cids - me * m).long()]
            if self.task == "classification":
                correct = torch.sum((logits.argmax(-1) == tgt.long()) * cmask)
                stats += torch.stack([correct, cmask.sum(), torch.zeros_like(correct)])
            elif self.task == "multilabel_classification":
                preds = (logits > 0).float() * cmask[:, None]
                t = tgt.float() * cmask[:, None]
                stats += torch.stack([torch.sum(preds * t),
                                      torch.sum(preds * (1 - t) * cmask[:, None]),
                                      torch.sum((1 - preds) * t * cmask[:, None])])
            else:
                err = (logits - tgt.to(logits.dtype)).float()
                stats += torch.stack([torch.sum(torch.square(err) * cmask[:, None]),
                                      torch.sum(torch.abs(err) * cmask[:, None]),
                                      cmask.sum() * logits.shape[-1]])
        dist.all_reduce(stats)
        return stats

    def evaluate(self, state: TrainState, store: GraphStore, fold: str = "val",
                 seed: int = 0) -> float:
        """Sampled fold metric on the node-sharded full graph (``eval_stats``);
        regression metrics negated, as ``Trainer.eval_fold``."""
        s = self.eval_stats(state, store, fold, seed).cpu().numpy().astype(np.float64)
        if self.task == "classification":
            return float(s[0] / max(s[1], 1.0))
        if self.task == "multilabel_classification":
            return float(2 * s[0] / max(2 * s[0] + s[1] + s[2], 1e-12))
        if self.task == "regression":
            return float(-s[0] / max(s[2], 1.0))
        return float(-s[1] / max(s[2], 1.0))

    def evaluate_exact(self, state: TrainState, store: GraphStore, fold: str = "val") -> float:
        """Fold metric from sharded exact layer-wise inference
        (``nn/full_graph.py::embed_all_nodes_partitioned``): the logits'
        shards are all-gathered, so every rank computes the same metric. A
        CSR trainer's evaluation shards go dense from here on (the exact
        pass walks whole rows)."""
        from tpu_sage_torch.nn.full_graph import embed_all_nodes_partitioned

        self._eval_dense_only = True
        graph, _ = self._full_graph_shard(store)
        local = embed_all_nodes_partitioned(self.model, graph, with_head=True)
        logits = all_gather_rows(local)[:store.n_nodes].cpu().numpy()
        ids = store.folds[fold]
        return fold_metric_np(store.task, logits[ids], store.targets[ids])


def _rank_setup(device, log):
    """``(device, log, lead)`` of a fit loop's rank: the rank's card under
    NCCL, else the CPU; rank 0 logs (to stdout by default), the others not.
    A barrier first: rank 0 writes the checkpoints while the others go on,
    so a fit that resumes from one an earlier fit in this group wrote must
    not read it before rank 0 is done, or the ranks resume at different
    epochs and their collectives never meet."""
    dist.barrier()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    lead = rank() == 0
    if log is None:
        log = lambda d: print(json.dumps(d), flush=True)  # noqa: E731
    return device, (log if lead else lambda d: None), lead


def log_head(trainer: PartitionedTrainer, log, csr: bool) -> None:
    """The run's first line: shards, the resolved halo mode (and the race),
    the layout when 2-D, the CSR window."""
    log({"n_shards": trainer.n_shards, "halo": trainer.halo_mode,
         **({"halo_measured_ms": trainer.halo_timings} if trainer.halo_timings else {}),
         **({"halo_measured_fallback": trainer.halo_fallback}
            if trainer.halo_fallback else {}),
         **({"layout": list(trainer.layout.shape)} if trainer.layout is not None else {}),
         **({"csr_window": trainer.csr_window} if csr else {})})


def fit_partitioned(
    store: GraphStore,
    config: TrainConfig,
    log: Optional[Callable[[Dict], None]] = None,
    eval_every_epoch: bool = True,
    resume_from: Optional[str] = None,
    checkpoint_every: int = 0,
    csr: bool = False,
    device: Optional[str | torch.device] = None,
    layout: Optional[Layout2D] = None,
):
    """``fit()`` for the node-sharded path, run by every rank of a process
    group: per-epoch training, one JSON line per epoch (rank 0 logs), sampled
    or exact validation (``exact_val``, thinned by ``exact_val_every``),
    ``save_best``, early stopping, ``checkpoint_every`` and resume. Rank 0
    writes the checkpoints, in the ``.npz`` layout both packages read; a run
    resumes at the epoch after the checkpoint's step on any shard count and
    either layout. ``device`` defaults to the rank's card under NCCL, else
    the CPU; ``layout`` as ``resolve_layout``. Returns ``(trainer, state,
    history)`` on every rank."""
    device, log, lead = _rank_setup(device, log)
    trainer, graph, fold_ids, fold_w = PartitionedTrainer.from_store(
        store, config, device, csr=csr, layout=resolve_layout(config, layout))
    config = trainer.config
    tracker = BestTracker(config, resume_from, log, write=lead)
    log_head(trainer, log, csr)

    use_exact_val = False
    if config.exact_val:
        from tpu_sage_torch.nn.full_graph import exact_supported

        use_exact_val = exact_supported(trainer.model)
        if not use_exact_val:
            log({"note": "exact_val unsupported for this aggregator; "
                         "falling back to sampled validation"})
        elif csr:
            log({"note": "exact_val densifies the EVAL graph shards "
                         "(m*max_degree per rank; training stays CSR)"})

    def eval_fold(state, fold, seed, exact=True):
        if use_exact_val and exact:
            return trainer.evaluate_exact(state, store, fold=fold)
        return trainer.evaluate(state, store, fold=fold, seed=seed)

    def exact_this_epoch(epoch):
        k = max(1, config.exact_val_every)
        return (epoch + 1) % k == 0 or epoch == config.epochs - 1

    state = trainer.init_state()
    state, start_epoch = resume_state(state, resume_from, trainer.steps_per_epoch, log)

    history = []
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        state, m = trainer.train_epoch(state, graph, fold_ids, fold_w)
        rec = {"epoch": epoch, "train_loss": float(m["loss"]), "lr": float(m["lr"]),
               "elapsed": round(time.time() - t0, 4), "n_shards": trainer.n_shards}
        if trainer.halo_mode == "bucketed":
            rec["halo_overflow"] = int(m["halo_overflow"])
        exact_now = exact_this_epoch(epoch)
        if eval_every_epoch and len(store.folds["val"]):
            rec["val_metric"] = eval_fold(state, "val", config.seed + 1, exact=exact_now)
        history.append(rec)
        log(rec)
        maybe_checkpoint(state, resume_from, checkpoint_every, epoch, log, config=config,
                         write=lead)
        tracked = rec.get("val_metric") if (not use_exact_val or exact_now) else None
        if tracker.update(tracked, state):
            break
    if eval_every_epoch and len(store.folds.get("test", [])):
        log({"final_test_metric": eval_fold(state, "test", config.seed + 2)})
    return trainer, state, history
