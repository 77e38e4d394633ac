"""Supervised training: ``Trainer.train_step`` (``tpu_sage_torch/train/trainer.py``)
in a closed loop over batches of the train fold. Work: the edges each step
samples, ``B * (f1 + f1 * f2)``.

Set-up makes the graph, the program's trainer as its entry point builds
it, weights and batches from the seed, and drives the first three steps
through the window's own call; the reference follows those steps.

The same trainer object then goes on into the window. Its first three
steps record what the comparison needs: each step's loss, the tree the
step sampled (seen where the step hands it to the encoder), Adam's first
moment after step 1 (``(1 - b1)`` times the first gradient) and the
parameters after step 3.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark import checks, counts, files, graphgen

FIRST_STEPS = 3


class Session:
    work_unit = "edges"

    def __init__(self, spec: dict, seed: int, device: torch.device,
                 program: Optional[dict] = None):
        from tpu_sage_torch.data.quantize import quantize_feats
        from tpu_sage_torch.graph.graph_data import DeviceGraph
        from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

        cfg, traffic = spec["config"], spec["traffic"]
        self.ref = files.reference(spec)
        g = self.graph_spec = cfg["graph"]
        self.inputs = graphgen.reddit_shaped(g, seed, device, graphgen.DTYPES[g["feature_dtype"]])
        self.batch = int(traffic["batch_size"])
        self.fanouts = tuple(int(f) for f in cfg["model"]["n_train_samples"])
        self.n_layers = len(cfg["model"]["output_dims"])
        self.lr = float(cfg["model"]["lr_init"])
        self.dtype = graphgen.DTYPES[cfg["model"]["compute_dtype"]]  # the reference's
        self.config = TrainConfig.from_dict(
            {**cfg["model"], "batch_size": self.batch,
             "seed": graphgen.sub_seed(seed, "program") % 2**31, **(program or {})})
        self.batches = graphgen.Batches(self.inputs.folds["train"], self.inputs.labels,
                                        self.batch, seed)
        feats = self.inputs.feats
        if self.config.feature_int8:  # the program's own int8 table path
            feats = quantize_feats(feats.float().cpu().numpy(), out_dtype=feats.dtype,
                                   device=device)
        self.graph = DeviceGraph(adj=self.inputs.adj, degrees=self.inputs.degrees,
                                 feats=feats, targets=self.inputs.labels)
        self.model = build_model(self.config, g["n_nodes"], g["n_classes"], g["feat_dim"])
        self.trainer = Trainer(self.model, self.config, self.batches.per_epoch)
        self.state = self.trainer.init_state(self.graph)
        shapes = self.ref.param_shapes(g["feat_dim"], cfg["model"], g["n_classes"])
        self.w0 = self.ref.init_params(shapes, graphgen.generator(seed, "weights", device),
                                       device)
        graphgen.give_weights(self.model, self.w0)
        self.losses: List[torch.Tensor] = []
        self._recording = True
        self._first_steps()
        self._recording = False

    @property
    def work_per_step(self) -> int:
        return counts.sampled_edges(self.batch, self.fanouts)

    def least_counts(self):
        g = self.graph_spec
        return counts.sage_mean_step(g["n_nodes"], g["feat_dim"],
                                     self.config.output_dims, self.fanouts, self.batch,
                                     self.inputs.feats.element_size(), self.n_params,
                                     n_classes=g["n_classes"])

    @property
    def peak_dtype(self) -> str:
        return self.config.compute_dtype

    @property
    def n_params(self) -> int:
        return sum(w.numel() for w in self.w0.values())

    # -- the step ----------------------------------------------------------
    def step(self) -> None:
        batch = self.batches.next()
        if self._recording:
            self.fed.append(batch)
        self.state, m = self.trainer.train_step(self.state, self.graph, *batch)
        self.losses.append(m["loss"])

    def _first_steps(self) -> None:
        self.fed, self.trees = [], []
        encode = self.model.encode

        def seen(levels, feats):
            self.trees.append([lv.detach().clone() for lv in levels])
            return encode(levels, feats)

        self.model.encode = seen
        try:
            for k in range(FIRST_STEPS):
                self.step()
                if k == 0:
                    opt = self.state.optimizer
                    b1 = opt.param_groups[0]["betas"][0]
                    self.first_grads = {
                        name: (opt.state[p]["exp_avg"] / (1 - b1)).clone()
                        if "exp_avg" in opt.state.get(p, {}) else None
                        for name, p in self.model.named_parameters()}
        finally:
            del self.model.encode
        self.params_after = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.first_losses = [float(x) for x in self.losses[:FIRST_STEPS]]
        self.losses.clear()

    # -- after the window --------------------------------------------------
    def nonfinite(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses).float())).sum())

    def release(self) -> None:
        """Drop the program's state; keep what the comparison reads."""
        self.losses.clear()
        self.trainer = self.model = self.state = None
        self.graph = None

    def compare(self) -> Dict[str, float]:
        ref_losses, ref_grads, ref_after = self.ref.train_steps(
            self.w0, [self._reference_loss(k) for k in range(FIRST_STEPS)], self.lr)
        moving = checks.moving_leaves(ref_grads)
        change = {k: self.params_after[k] - self.w0[k] for k in self.w0}
        ref_change = {k: ref_after[k] - self.w0[k] for k in self.w0}
        steps = [abs(p - r) / abs(r) for p, r in zip(self.first_losses, ref_losses)]
        updates = checks.leaf_gaps(change, ref_change, moving)
        grads = checks.leaf_gaps(self.first_grads, ref_grads)
        return {
            "loss_gap": max(steps),
            "first_loss_gap": steps[0],
            "grad_gap": max(grads.values()),
            "update_gap": max(updates.values()),
            "bad_samples": float(sum(self._sample_faults(k) for k in range(FIRST_STEPS))),
            # not compared; for the readings
            **{f"grad_gap.{k}": v for k, v in grads.items()},
            **{f"update_gap.{k}": v for k, v in updates.items()},
        }

    def _reference_loss(self, k: int):
        """Step ``k``'s loss as a function of the reference's parameters."""
        _, labels = self.fed[k]
        levels = self.trees[k]
        return lambda p: self.ref.supervised_loss(p, self.inputs.feats, levels, labels,
                                                  self.n_layers, self.dtype)

    def _sample_faults(self, k: int) -> int:
        """Sampled ids of step ``k`` that no sound sampler gives."""
        ids = self.fed[k][0]
        if k >= len(self.trees) or self.trees[k][0].shape != ids.shape:
            return counts.sampled_edges(self.batch, self.fanouts)
        levels = self.trees[k]
        return (int((levels[0] != ids).sum())
                + checks.bad_tree(self.inputs.adj, self.inputs.degrees, levels, self.fanouts))
