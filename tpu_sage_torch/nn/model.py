"""The supervised GraphSAGE model (counterpart of ``tpu_sage/nn/model.py``).

Sampling builds a static-shape neighborhood tree outside the network
(``tpu_sage_torch.sample``); the network gathers each level's feature rows,
collapses the tree top-down with one aggregator per layer (that layer's
weights applied at every remaining depth), L2-normalizes the embedding and
applies a linear head.

With ``fuse_last`` on (``"auto"``, the default) and the identity prep, the
deepest level's rows have one consumer, the first layer's per-root summary,
which finishes the deepest pairing through ``combine_from_summary``. For
``mean`` and ``gcn`` the level is never gathered row by row:
``row_gather_fanout_mean`` returns its per-root means in one pass. For the
others the level is gathered whole (one ``gather_rows``) and summarised at
once (``_deepest_summary``); the JAX package gathers and summarises it in
root-aligned chunks, which gives the same values. ``lstm`` is fused only
under ``fuse_last="all"``.

With ``fuse_first_layer`` (mean aggregator, identity prep, a feature table)
the first pass projects the whole table once per branch and gathers in
output space (``nn/fused.py::project_gather``, whose backward computes
``dW`` from the raw rows); the later layers run as usual.

The feature table may be int8 (``data/quantize.py::QuantizedFeats``): every
level's rows then arrive dequantized in the compute dtype through
``row_gather``, and the fused fanout mean is the int8 kernel's
(``int8_summean``: the int32 sum times ``scale / F``, else the mean of the
dequantized rows).

``gather_form`` picks the levels' gather form as the JAX package's does
(``"plain"`` by default; ``"masked"`` and ``"masked_chunked"`` zero-fill
out-of-range ids; ``gather_form_deep`` the deepest level's when it is
gathered whole), and ``TPU_SAGE_GATHER_FORM`` and ``TPU_SAGE_FUSE_LAST``
override the config (``overrides.py``). The samplers give in-range ids only,
so the forms give the same values; the fused fanout mean clamps, as the JAX
package's XLA form does in ``plain``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_sage_torch import overrides
from tpu_sage_torch.nn.aggregators import aggregator_lookup
from tpu_sage_torch.nn.dense import Dense
from tpu_sage_torch.nn.fused import project_gather
from tpu_sage_torch.nn.preps import prep_lookup
from tpu_sage_torch.ops import row_gather, row_gather_fanout_mean
from tpu_sage_torch.sample.csr import graph_sample_tree


def _l2_normalize(x: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """Row-wise L2 normalization with a NaN-safe backward at zero rows:
    ``x * rsqrt(sum(x²) + eps)``, the sum in ``x.dtype``. Zero rows map to
    zero with zero gradient."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(sq + eps)


activation_lookup = {
    "relu": torch.relu,
    "elu": torch.nn.functional.elu,
    "tanh": torch.tanh,
    "identity": None,
    None: None,
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One aggregation layer: train/eval fanouts, width, activation."""

    n_train_samples: int = 25
    n_val_samples: int = 25
    output_dim: int = 128
    activation: Optional[str] = "relu"


def default_layer_specs(
    fanouts: Sequence[int] = (25, 10),
    val_fanouts: Optional[Sequence[int]] = None,
    output_dims: Sequence[int] = (128, 128),
) -> Tuple[LayerSpec, ...]:
    """The canonical 2-layer spec: fanout (25, 10), dims (128, 128), ReLU on
    all but the last layer."""
    if val_fanouts is None:
        val_fanouts = fanouts
    n = len(fanouts)
    return tuple(
        LayerSpec(
            n_train_samples=int(f),
            n_val_samples=int(v),
            output_dim=int(d),
            activation="relu" if i < n - 1 else "identity",
        )
        for i, (f, v, d) in enumerate(zip(fanouts, val_fanouts, output_dims))
    )


class GSSupervised(torch.nn.Module):
    """Supervised GraphSAGE: prep → L aggregation passes → normalize → head.

    Call with the per-level flat id tensors from ``sample_tree`` (or injected
    levels, for parity tests) and the full feature table. ``dtype`` is the
    compute dtype (``torch.bfloat16`` for speed); params stay f32.
    """

    def __init__(
        self,
        layer_specs: Tuple[LayerSpec, ...],
        n_classes: int,
        feat_dim: int,
        aggregator_class: str = "mean",
        prep_class: str = "identity",
        n_nodes: int = 0,
        embedding_dim: int = 64,
        combine: str = "concat",
        normalize: bool = True,
        agg_hidden_dim: int = 512,
        dtype: Optional[torch.dtype] = None,
        fuse_last: str = "auto",
        int8_summean: bool = True,
        fuse_first_layer: bool = False,
        gather_form: Optional[str] = None,
        gather_form_deep: Optional[str] = None,
    ):
        super().__init__()
        if aggregator_class not in aggregator_lookup:
            raise ValueError(f"unknown aggregator_class: {aggregator_class!r}")
        if prep_class not in prep_lookup:
            raise ValueError(f"unknown prep_class: {prep_class!r}")
        if fuse_last not in ("auto", "off", "all"):
            raise ValueError(f"unknown fuse_last: {fuse_last!r}")
        self.layer_specs = tuple(layer_specs)
        self.aggregator_class = aggregator_class
        self.prep_class = prep_class
        self.normalize = normalize
        self.fuse_last = fuse_last
        self.int8_summean = int8_summean
        self.fuse_first_layer = fuse_first_layer
        self.gather_form = gather_form
        self.gather_form_deep = gather_form_deep
        self.prep = prep_lookup[prep_class](feat_dim, n_nodes=n_nodes,
                                            embedding_dim=embedding_dim)
        agg_cls = aggregator_lookup[aggregator_class]
        layers, in_dim = [], self.prep.out_dim()
        for spec in self.layer_specs:
            agg = agg_cls(in_dim, spec.output_dim, activation=activation_lookup[spec.activation],
                          combine=combine, hidden_dim=agg_hidden_dim, dtype=dtype)
            layers.append(agg)
            in_dim = agg.out_dim()
        self.agg_layers = torch.nn.ModuleList(layers)
        self.fc = Dense(in_dim, n_classes, use_bias=True, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init from ``generator``, module by module in registration
        order: lecun-normal kernels (orthogonal for the LSTM's ``hz``), zero
        biases, the embedding table's normal."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def fuses_last(self, levels: List[torch.Tensor], feats: Optional[torch.Tensor]) -> bool:
        """The JAX package's ``fuse_last`` policy: summarise the deepest level
        right after its gather when the prep is the identity, the tree has two
        levels or more, ``fuse_last`` (or ``TPU_SAGE_FUSE_LAST``) is not
        ``"off"``, and the aggregator is not ``lstm`` unless it is ``"all"``."""
        fl = overrides.fuse_last(self.fuse_last)
        return (feats is not None and self.prep_class == "identity" and len(levels) >= 2
                and fl != "off" and (self.aggregator_class != "lstm" or fl == "all"))

    def encode(self, levels: List[torch.Tensor], feats: Optional[torch.Tensor]) -> torch.Tensor:
        """Collapse the neighborhood tree into per-root embeddings ``(B, D)``;
        the per-level gathers happen here. ``fuse_first_layer`` takes
        precedence over ``fuse_last`` under the reference's conditions: the
        mean aggregator, the identity prep, a feature table, a layer."""
        if (self.fuse_first_layer and self.aggregator_class == "mean"
                and self.prep_class == "identity" and feats is not None
                and len(self.layer_specs) >= 1):
            return self._encode_fused(levels, feats)
        form = overrides.gather_form(self.gather_form) or "plain"
        base_form = "masked" if form == "masked_chunked" else form
        fuse_last = self.fuses_last(levels, feats)
        gathered = [
            None if feats is None else row_gather(feats, ids, form=base_form)
            for ids in (levels[:-1] if fuse_last else levels)
        ]
        if not fuse_last:
            return self.encode_gathered(levels, gathered)
        fanout = levels[-1].shape[0] // levels[-2].shape[0]
        if self.aggregator_class in ("mean", "gcn"):
            # f32 means, rounded to the table's dtype as the reference's
            # jnp.mean of the gathered rows returns it (an int8 table's
            # kernel returns its compute dtype already)
            summary = row_gather_fanout_mean(feats, levels[-1], fanout,
                                             int8_summean=self.int8_summean).to(feats.dtype)
        else:
            summary = self._deepest_summary(levels, gathered[-1], feats, fanout,
                                            self.gather_form_deep or base_form)
        gathered.append(summary)
        return self.encode_gathered(levels, gathered, last_reduced_fanout=fanout)

    def _deepest_summary(self, levels: List[torch.Tensor], x_self_rows: torch.Tensor,
                         feats: torch.Tensor, fanout: int, form: str) -> torch.Tensor:
        """The deepest level gathered in one launch and summarised per root by
        the first aggregator (pooled MLP, attention over the root's own group,
        LSTM over it); ``x_self_rows`` are the level above's rows (the
        attention's queries)."""
        rows = row_gather(feats, levels[-1], form=form)
        n_roots = levels[-2].shape[0]
        return self.agg_layers[0].neigh_summary(x_self_rows,
                                                rows.reshape(n_roots, fanout, -1))

    def _encode_fused(self, levels: List[torch.Tensor], feats: torch.Tensor) -> torch.Tensor:
        """The first aggregation pass through whole-table projections. Each
        branch's kernel enters in its ``Dense`` compute dtype, as the
        reference's ``fc_self(eye)`` extracts it (rounded to bf16 under a
        bf16 model), so gradients reach the ordinary ``fc_self``/``fc_neigh``
        parameters; the neighbor levels come back as their fanout means."""
        agg0 = self.agg_layers[0]
        n_levels = len(levels) - 1
        w_self = agg0.fc_self.kernel.to(agg0.fc_self.compute_dtype(feats))
        w_neigh = agg0.fc_neigh.kernel.to(agg0.fc_neigh.compute_dtype(feats))
        fanouts = [levels[d + 1].shape[0] // levels[d].shape[0] for d in range(n_levels)]
        self_rows = project_gather(feats, w_self, levels[:n_levels])
        neigh_means = project_gather(feats, w_neigh, levels[1:], fanouts)
        h = [agg0.combine_projected(s, m) for s, m in zip(self_rows, neigh_means)]
        for agg in self.agg_layers[1:]:
            h = [agg(h[d], h[d + 1].reshape(h[d].shape[0], -1, h[d + 1].shape[-1]))
                 for d in range(len(h) - 1)]
        out = h[0]
        if self.normalize:
            out = _l2_normalize(out)
        return out

    def encode_gathered(
        self,
        levels: List[torch.Tensor],
        level_feats: List[Optional[torch.Tensor]],
        last_reduced_fanout: Optional[int] = None,
    ) -> torch.Tensor:
        """As ``encode`` but with each level's feature rows already gathered.

        ``last_reduced_fanout``: set when the deepest level arrives
        pre-summarized per root (``(n_roots, D)`` instead of
        ``(n_roots·fanout, D)``); the first pass's deepest pairing then goes
        through ``combine_from_summary``."""
        if len(levels) != len(self.layer_specs) + 1:
            raise ValueError(
                f"need {len(self.layer_specs) + 1} tree levels, got {len(levels)}")
        h = [self.prep(ids, x) for ids, x in zip(levels, level_feats)]
        for li, agg in enumerate(self.agg_layers):
            nxt = []
            for d in range(len(h) - 1):
                n_self = h[d].shape[0]
                if li == 0 and d == len(h) - 2 and last_reduced_fanout is not None:
                    nxt.append(agg.combine_from_summary(h[d], h[d + 1], last_reduced_fanout))
                    continue
                x_neigh = h[d + 1].reshape(n_self, -1, h[d + 1].shape[-1])
                nxt.append(agg(h[d], x_neigh))
            h = nxt
        out = h[0]
        if self.normalize:
            out = _l2_normalize(out)
        return out

    def forward(self, levels: List[torch.Tensor], feats: Optional[torch.Tensor]) -> torch.Tensor:
        return self.fc(self.encode(levels, feats))

    def forward_gathered(
        self,
        levels: List[torch.Tensor],
        level_feats: List[Optional[torch.Tensor]],
        last_reduced_fanout: Optional[int] = None,
    ) -> torch.Tensor:
        """Logits from pre-gathered level features (the partitioned path,
        ``dist/train.py``). ``last_reduced_fanout`` as for
        ``encode_gathered``: gcn needs it when the deepest level arrives as
        per-root means, since its reduce spans self."""
        return self.fc(self.encode_gathered(levels, level_feats, last_reduced_fanout))

    def fanouts(self, train: bool) -> Tuple[int, ...]:
        return tuple(
            (s.n_train_samples if train else s.n_val_samples) for s in self.layer_specs
        )

    def forward_with_sampling(
        self,
        graph,
        ids: torch.Tensor,
        feats: Optional[torch.Tensor],
        train: bool,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Sample the tree from ``graph`` (a ``DeviceGraph`` or a
        ``CSRDeviceGraph``; ``sample/csr.py::graph_sample_tree``), then run
        the network."""
        levels = graph_sample_tree(graph, ids, self.fanouts(train), generator=generator)
        return self(levels, feats)
