"""Unsupervised GraphSAGE: skip-gram with negative sampling over random walks
(counterpart of ``tpu_sage/train/unsupervised.py``).

The objective (Hamilton et al. §3.2)::

    L = −log σ(z_u·z_v) − Σ_{n ∈ negatives} log σ(−z_u·z_n)

where ``v`` ends a ``walk_length``-hop random walk from ``u`` (or is drawn
from a precomputed walk corpus) and the negatives are uniform over the
nodes, or drawn ∝ ``max(degree, 1)^neg_power``. The encoder is the
supervised ``GSSupervised`` tower (its head unused), so any aggregator and
prep works.

Walks run on the device: each hop is one ``uniform_neighbor_sample`` at
fanout 1 (the ``sample_hop`` kernel); on CSR adjacency the whole walk is one
``csr_tree`` launch (up to 4 hops a launch).
Anchors, positives and negatives share one sampled tree and one encoder
pass: ``(2 + Q)·B`` roots.

Randomness: one generator on the device (the supervised trainer's, seeded
``seed + 2``) draws, per step, the positives (a uniform per walk hop, or
the corpus' walk and position), the negatives and the tree, in that order.
``torch.Generator`` cannot reproduce ``jax.random``; the walk functions
take each hop's uniforms ``us`` and the corpus lookup its ``wi``/``pi``,
and the step takes ``pos``, ``neg`` and ``levels``, so the tests feed the
reference's draws.

The downstream probe (``logistic_probe``) is multinomial logistic
regression fitted with ``torch.optim.LBFGS`` on the embeddings' device.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_sage_torch.kernels.sample_hop import csr_tree
from tpu_sage_torch.nn.model import GSSupervised
from tpu_sage_torch.ops import row_gather
from tpu_sage_torch.sample.csr import graph_sample_tree, hop_uniforms
from tpu_sage_torch.sample.sampler import uniform_neighbor_sample
from tpu_sage_torch.train.checkpoint import BestTracker, maybe_checkpoint, resume_state
from tpu_sage_torch.train.trainer import (COMPUTE_DTYPES, Graph, TrainConfig, Trainer,
                                          TrainState, build_model, check_ported)


def random_walk(adj: torch.Tensor, degrees: torch.Tensor, ids: torch.Tensor, length: int, *,
                generator: Optional[torch.Generator] = None,
                us: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Uniform random walk of ``length`` hops on the dense padded table;
    returns the final nodes ``(B,)`` int32. ``us`` optionally gives each
    hop's ``(B, 1)`` uniforms; without it they are drawn from
    ``generator``."""
    cur = ids.to(torch.int32)
    for hop in range(length):
        cur = uniform_neighbor_sample(adj, degrees, cur, 1, generator=generator,
                                      u=None if us is None else us[hop])[:, 0]
    return cur


def graph_random_walk(graph, ids: torch.Tensor, length: int, *,
                      generator: Optional[torch.Generator] = None,
                      us: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """``random_walk`` on whichever storage ``graph`` has: CSR (it has
    ``indptr``; the window and element hops read the same neighbors, so
    either is one ``csr_tree`` launch of fanout 1 a hop, its last level
    kept) or the dense padded table."""
    if not hasattr(graph, "indptr"):
        return random_walk(graph.adj, graph.degrees, ids, length, generator=generator, us=us)
    cur = ids.to(torch.int32).contiguous()
    if length == 0:
        return cur
    return csr_tree(graph.indptr, graph.indices, graph.degrees, cur,
                    hop_uniforms(cur, (1,) * length, generator, us), last_only=True)[0]


def corpus_positives(walks: torch.Tensor, ids: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     wi: Optional[torch.Tensor] = None,
                     pi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Positives from a walk corpus ``(n_nodes, n_walks, L+1)``:
    ``walks[ids][arange(B), wi, pi]`` with ``wi`` uniform in ``[0, n_walks)``
    and ``pi`` in ``[1, L+1)`` (drawn from ``generator`` unless given).
    ``walks[ids]`` is one ``row_gather`` of the corpus viewed as
    ``(n_nodes, n_walks·(L+1))`` int32 rows."""
    n, n_walks, width = walks.shape
    b = ids.shape[0]
    if wi is None:
        wi = torch.randint(0, n_walks, (b,), generator=generator, device=ids.device)
    if pi is None:
        pi = torch.randint(1, width, (b,), generator=generator, device=ids.device)
    rows = row_gather(walks.view(n, n_walks * width), ids).view(b, n_walks, width)
    return rows[torch.arange(b, device=ids.device), wi.long(), pi.long()]


def draw_negatives(degrees: torch.Tensor, count: int, neg_power: float = 0.0, *,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``count`` negatives, int32: uniform over the nodes, or with
    ``neg_power`` > 0 drawn with probability ∝ ``max(degree, 1)^neg_power``
    (the reference's ``categorical`` over ``neg_power·log(max(degree, 1))``)."""
    n = degrees.shape[0]
    if neg_power > 0:
        weights = degrees.float().clamp_min(1.0) ** neg_power
        neg = torch.multinomial(weights, count, replacement=True, generator=generator)
        return neg.to(torch.int32)
    return torch.randint(0, n, (count,), generator=generator, device=degrees.device,
                         dtype=torch.int32)


def nce_loss(z_u: torch.Tensor, z_pos: torch.Tensor, z_neg: torch.Tensor) -> torch.Tensor:
    """``mean(−logσ(z_u·z_pos) − Σ_q logσ(−z_u·z_neg[:, q]))`` for anchors
    ``(B, D)``, positives ``(B, D)`` and negatives ``(B, Q, D)``, reduced in
    the reference's order."""
    pos_logit = torch.sum(z_u * z_pos, dim=-1)                 # (B,)
    neg_logit = torch.einsum("bd,bqd->bq", z_u, z_neg)         # (B, Q)
    pos_loss = -F.logsigmoid(pos_logit)
    neg_loss = -torch.sum(F.logsigmoid(-neg_logit), dim=-1)
    return torch.mean(pos_loss + neg_loss)


@dataclasses.dataclass(frozen=True)
class UnsupConfig:
    """Knobs specific to the unsupervised objective."""

    walk_length: int = 3     # hops between anchor and positive
    n_negatives: int = 10    # Q
    neg_power: float = 0.0   # 0 = uniform; 0.75 = word2vec-style degree smoothing
    probe_every: int = 0     # logistic-probe val accuracy every K epochs (0 = the
    # final epoch only); patience/save_best key on it and resolve 0 to 1


def unsup_gather_defaults(config: TrainConfig) -> TrainConfig:
    """The reference's gather defaults for the unsupervised workload,
    ``gather_form="masked_chunked"`` and ``gather_chunks=48``, written where
    the user left them unset. They change nothing on the port (one kernel
    per gather); the config a checkpoint records stays the reference's."""
    if config.gather_form is None:
        config = config.replace(gather_form="masked_chunked")
    if config.gather_chunks is None:
        config = config.replace(gather_chunks=48)
    return config


class UnsupervisedTrainer(Trainer):
    """Trains the encoder with the NCE objective; shares ``Trainer``'s
    config, LR schedule, optimizer and ``init_state``."""

    def __init__(self, model: GSSupervised, config: TrainConfig, unsup: UnsupConfig,
                 steps_per_epoch: int):
        super().__init__(model, config, steps_per_epoch)
        self.unsup = unsup

    def nce_loss_and_grads(
        self,
        state: TrainState,
        graph: Graph,
        ids: torch.Tensor,
        walks: Optional[torch.Tensor] = None,
        *,
        pos: Optional[torch.Tensor] = None,
        neg: Optional[torch.Tensor] = None,
        levels: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """The NCE loss of a batch of anchors ``ids``, its gradients left in
        the parameters' ``.grad`` (zeros for the unused head, as JAX's
        gradient has them). Positives from a walk (or from the corpus
        ``walks``), negatives, then one tree over ``cat(ids, pos, neg)``,
        each drawn from ``state.generator`` unless injected; injected
        ``levels`` replace all three draws."""
        b, q = ids.shape[0], self.unsup.n_negatives
        gen = state.generator
        if levels is None:
            ids = ids.to(torch.int32)
            if pos is None:
                pos = (corpus_positives(walks, ids, generator=gen) if walks is not None
                       else graph_random_walk(graph, ids, self.unsup.walk_length, generator=gen))
            if neg is None:
                neg = draw_negatives(graph.degrees, b * q, self.unsup.neg_power, generator=gen)
            roots = torch.cat([ids, pos.to(torch.int32), neg.to(torch.int32)])
            levels = graph_sample_tree(graph, roots, self.model.fanouts(train=True),
                                       generator=gen)
        state.optimizer.zero_grad(set_to_none=True)
        z = self.model.encode(list(levels), graph.feats)
        loss = nce_loss(z[:b], z[b:2 * b], z[2 * b:].reshape(b, q, -1))
        loss.backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss.detach()

    def train_step(self, state: TrainState, graph: Graph, ids: torch.Tensor,
                   walks: Optional[torch.Tensor] = None, **inject) -> Tuple[TrainState, Dict]:
        """One optimizer step on a batch of anchors; ``inject`` passes
        ``pos``, ``neg`` or ``levels`` to ``nce_loss_and_grads``."""
        lr = self._lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        loss = self.nce_loss_and_grads(state, graph, ids, walks, **inject)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss}

    def train_epoch(self, state: TrainState, graph: Graph, node_ids: torch.Tensor,
                    walks: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict]:
        """One epoch over the train-fold ``node_ids``: a device permutation,
        whole batches, a loop of steps; the mean loss."""
        b = self.config.batch_size
        n_batches = max(1, node_ids.shape[0] // b)
        perm = torch.randperm(node_ids.shape[0], generator=state.generator,
                              device=node_ids.device)[:n_batches * b]
        ids_b = node_ids[perm].view(n_batches, b)
        losses = []
        for ids in ids_b:
            state, m = self.train_step(state, graph, ids, walks)
            losses.append(m["loss"])
        return state, {"loss": torch.stack(losses).float().mean()}

    @torch.no_grad()
    def embed_batch(self, state: TrainState, graph: Graph, ids: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """Embeddings ``(B, D)`` of ``ids`` from a tree sampled with the
        train fanouts, as the reference encodes."""
        levels = graph_sample_tree(graph, ids.to(torch.int32), state.model.fanouts(train=True),
                                   generator=generator)
        return state.model.encode(levels, graph.feats)

    def embed_all(self, state: TrainState, graph: Graph, ids: np.ndarray,
                  batch_size: int = 512, seed: int = 0) -> torch.Tensor:
        """f32 embeddings of any node set, in batches padded with node 0
        (the probe's protocol), on the graph's device; the trees are drawn
        from a generator seeded ``seed``."""
        gen = torch.Generator(device=graph.device).manual_seed(seed)
        n = len(ids)
        padded = np.concatenate([np.asarray(ids), np.zeros((-n) % batch_size, np.int64)])
        ids_d = torch.as_tensor(padded, dtype=torch.int32, device=graph.device)
        out = [self.embed_batch(state, graph, ids_d[i:i + batch_size], gen).float()
               for i in range(0, len(padded), batch_size)]
        return torch.cat(out)[:n]


def logistic_probe(embed_fn: Callable[[np.ndarray], torch.Tensor], targets: np.ndarray,
                   folds, max_iter: int = 200) -> Optional[float]:
    """Val accuracy of a logistic regression fitted on the frozen train-fold
    embeddings (the paper's unsupervised evaluation, [P] §4);
    ``embed_fn(ids) -> (len(ids), D)``, a tensor or an array. None when a
    fold is empty.

    It is scikit-learn's ``LogisticRegression()`` default, written out: L2
    penalty with ``C = 1``, an unpenalised intercept, and the objective
    scikit-learn 1.9 minimises with L-BFGS, ``mean_i loss_i + ||W||² /
    (2·C·n)``, where ``loss_i`` is the softmax cross-entropy over the
    classes of the train fold (one weight vector per class), or for two
    classes the binary logistic loss of one weight vector. Solved in f64 by
    ``torch.optim.LBFGS`` on the embeddings' device from zeros, with
    scikit-learn's settings (``max_iter``, history 10, strong-Wolfe line
    search, gradient tolerance 1e-4, change tolerance 64·eps)."""
    tr, va = folds["train"], folds["val"]
    if not (len(tr) and len(va)):
        return None
    x_tr = torch.as_tensor(embed_fn(tr)).to(torch.float64)
    dev = x_tr.device
    classes = np.unique(targets[tr])
    y = torch.as_tensor(np.searchsorted(classes, targets[tr]), device=dev)
    n, d = x_tr.shape
    n_out = 1 if len(classes) == 2 else len(classes)
    w = torch.zeros((d, n_out), dtype=torch.float64, device=dev, requires_grad=True)
    bias = torch.zeros(n_out, dtype=torch.float64, device=dev, requires_grad=True)
    opt = torch.optim.LBFGS([w, bias], lr=1.0, max_iter=max_iter, max_eval=15000,
                            tolerance_grad=1e-4, tolerance_change=64 * np.finfo(float).eps,
                            history_size=10, line_search_fn="strong_wolfe")

    def objective():
        opt.zero_grad()
        raw = x_tr @ w + bias
        if n_out == 1:
            loss = F.binary_cross_entropy_with_logits(raw[:, 0], y.to(torch.float64))
        else:
            loss = F.cross_entropy(raw, y)
        loss = loss + torch.sum(w * w) / (2.0 * n)
        loss.backward()
        return loss

    opt.step(objective)
    with torch.no_grad():
        raw = torch.as_tensor(embed_fn(va)).to(device=dev, dtype=torch.float64) @ w + bias
        pick = (raw[:, 0] > 0).long() if n_out == 1 else raw.argmax(-1)
    pred = classes[pick.cpu().numpy()]
    return float(np.mean(pred == targets[va]))


def resolve_probe_every(unsup: UnsupConfig, tracker, can_probe: bool, log) -> tuple:
    """patience/save_best need a per-epoch metric: with either set and
    ``probe_every`` unset, probe every epoch; when no probe is possible at
    all (not a classification task, or ``probe=False``), deactivate the
    tracker with a note. Returns ``(probe_every, tracker)``."""
    probe_every = unsup.probe_every
    if tracker.active:
        if not can_probe:
            log({"note": "patience/save_best inactive: the unsupervised loop "
                         "has no per-epoch metric for this task (the probe "
                         "needs a classification problem and probe=True)"})
            tracker.patience, tracker.save_best = 0, False
        elif probe_every <= 0:
            probe_every = 1
            log({"note": "patience/save_best key on the logistic probe; "
                         "probing every epoch (set unsup.probe_every to thin)"})
    return probe_every, tracker


def fit_unsupervised(
    problem,
    config: TrainConfig,
    unsup: Optional[UnsupConfig] = None,
    log: Optional[Callable[[Dict], None]] = None,
    walks: Optional[np.ndarray] = None,
    resume_from: Optional[str] = None,
    checkpoint_every: int = 0,
    probe: bool = True,
    csr: bool = False,
    device: str | torch.device = "cuda",
) -> Tuple[UnsupervisedTrainer, TrainState, list]:
    """Epoch loop over the train fold with the NCE objective.

    Training samples the train-edge graph; the probe embeds on the full
    graph (uploaded on first use). ``walks`` (or ``problem.walks``) is a
    corpus ``(n_nodes, n_walks, L+1)`` whose positives replace the walks.
    ``resume_from``/``checkpoint_every``: ``fit``'s checkpoint and resume.
    With ``probe`` the logistic-probe val accuracy (classification tasks) is
    recorded every ``unsup.probe_every`` epochs and after the last epoch;
    ``config.patience``/``config.save_best`` key on it. ``csr``: CSR
    adjacency; ``config.feature_int8``: the int8 table. ``device="cuda"``
    without a card raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_unsupervised(device='cuda') needs a CUDA device; "
                           "pass device='cpu' for the CPU")
    if unsup is None:
        unsup = UnsupConfig()
    if log is None:
        log = lambda d: print(json.dumps(d), flush=True)  # noqa: E731

    config = unsup_gather_defaults(config)
    check_ported(config)
    train_ids = problem.folds["train"]
    if len(train_ids) < config.batch_size:
        config = config.replace(batch_size=max(1, len(train_ids)))
        log({"note": f"batch_size clamped to train fold size {config.batch_size}"})
    steps_per_epoch = max(1, len(train_ids) // config.batch_size)
    model = build_model(config, problem.n_nodes, max(problem.n_classes, 2), problem.feats_dim)
    trainer = UnsupervisedTrainer(model, config, unsup, steps_per_epoch)
    storage = dict(dtype=COMPUTE_DTYPES[config.compute_dtype], device=device, csr=csr,
                   quantize=config.feature_int8)
    graph = problem.device_graph(train=True, **storage)
    state = trainer.init_state(graph)
    if walks is None:
        walks = getattr(problem, "walks", None)
    if walks is not None and walks.shape[0] != problem.n_nodes:
        # positives index the corpus by global node id: a corpus made for a
        # subset of start nodes would give wrong positives without an error
        raise ValueError(
            f"walk corpus must cover every node (walks.shape[0]="
            f"{walks.shape[0]} != n_nodes={problem.n_nodes}); regenerate with "
            f"starts=arange(n_nodes)")
    walks_d = None if walks is None else torch.as_tensor(
        np.asarray(walks), dtype=torch.int32).to(device).contiguous()

    state, start_epoch = resume_state(state, resume_from, steps_per_epoch, log)
    node_ids = torch.as_tensor(train_ids, dtype=torch.int32, device=device)
    tracker = BestTracker(config, resume_from, log)
    can_probe = probe and problem.task == "classification"
    probe_every, tracker = resolve_probe_every(unsup, tracker, can_probe, log)

    def run_probe(st: TrainState) -> Optional[float]:
        graph_full = problem.device_graph(train=False, **storage)  # cached after the first
        return logistic_probe(lambda ids: trainer.embed_all(st, graph_full, ids),
                              problem.store.targets, problem.folds)

    history = []
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        state, m = trainer.train_epoch(state, graph, node_ids, walks_d)
        rec = {"epoch": epoch, "unsup_loss": float(m["loss"]),
               "elapsed": round(time.time() - t0, 4)}
        acc = None
        if can_probe and probe_every > 0 and (epoch + 1) % probe_every == 0:
            acc = run_probe(state)
            if acc is not None:
                rec["probe_val_accuracy"] = acc
        history.append(rec)
        log(rec)
        maybe_checkpoint(state, resume_from, checkpoint_every, epoch, log, config=config)
        if tracker.update(acc, state):
            break
    if can_probe and history and "probe_val_accuracy" not in history[-1]:
        acc = run_probe(state)
        if acc is not None:
            history[-1]["probe_val_accuracy"] = acc
            log({"probe_val_accuracy": acc})
            # the final probe counts for best tracking too: with probe_every
            # > 1 it may be the run's best state, which save_best must keep
            tracker.update(acc, state)
    return trainer, state, history
