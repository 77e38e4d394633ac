"""Exact embeddings of every node: ``nn/full_graph.py::embed_all_nodes``
over the whole graph in chunks, passes back to back, the table in the dtype
the exporter places it in. Work: the nodes each pass embeds.

The first and the last pass of the window are kept and compared, every
node of each, with the reference's exact embeddings."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark import counts, files, graphgen

WARM_PASSES = 2


class Session:
    work_unit = "nodes"

    def __init__(self, spec: dict, seed: int, device: torch.device,
                 program: Optional[dict] = None):
        from tpu_sage_torch.train.trainer import TrainConfig, build_model

        cfg, traffic = spec["config"], spec["traffic"]
        self.ref = files.reference(spec)
        self.graph_spec = g = cfg["graph"]
        self.chunk = int(traffic["chunk"])
        self.output_dims = tuple(cfg["model"]["output_dims"])
        pooled = cfg["model"]["aggregator_class"] in ("max_pool", "mean_pool")
        self.pool_hidden = int(cfg["model"]["agg_hidden_dim"]) if pooled else 0
        self.inputs = graphgen.reddit_shaped(g, seed, device,
                                             graphgen.DTYPES[traffic["table_dtype"]])
        config = TrainConfig.from_dict({**cfg["model"], **(program or {})})
        self.model = build_model(config, g["n_nodes"], g["n_classes"], g["feat_dim"]).to(device)
        shapes = self.ref.param_shapes(g["feat_dim"], cfg["model"], g["n_classes"])
        self.w0 = self.ref.init_params(shapes, graphgen.generator(seed, "weights", device),
                                       device)
        graphgen.give_weights(self.model, self.w0)
        self.graph = self._program_graph()
        self.outputs = []  # the window's first and last passes
        for _ in range(WARM_PASSES):
            self._pass()
        self.outputs.clear()

    def _program_graph(self):
        """The graph the program's pass takes: the whole of the inputs."""
        from tpu_sage_torch.graph.graph_data import DeviceGraph

        return DeviceGraph(adj=self.inputs.adj, degrees=self.inputs.degrees,
                           feats=self.inputs.feats, targets=self.inputs.labels)

    @property
    def work_per_step(self) -> int:
        return self.graph_spec["n_nodes"]

    @property
    def peak_dtype(self) -> str:
        return str(self.inputs.feats.dtype).replace("torch.", "")

    def least_counts(self) -> Dict[str, float]:
        g = self.graph_spec
        return counts.exact_pass(g["n_nodes"], g["feat_dim"], self.output_dims, g["degree"],
                                 self.inputs.feats.element_size(), self.chunk, self.pool_hidden)

    def _pass(self) -> torch.Tensor:
        from tpu_sage_torch.nn.full_graph import embed_all_nodes

        return embed_all_nodes(self.model, self.graph, chunk=self.chunk)

    def step(self) -> None:
        out = self._pass()
        if len(self.outputs) == 2:
            self.outputs[1] = out
        else:
            self.outputs.append(out)

    def nonfinite(self) -> int:
        return sum(int(not torch.isfinite(o).all()) for o in self.outputs)

    def release(self) -> None:
        self.model = self.graph = None

    def reference(self, precision: str = "float32") -> torch.Tensor:
        return self.ref.exact_embeddings(self.w0, self.inputs.feats, self.inputs.adj,
                                         self.inputs.degrees, len(self.output_dims),
                                         chunk=self.chunk, precision=precision)

    @torch.no_grad()
    def compare(self) -> Dict[str, float]:
        ref = self.reference()
        if not self.outputs:
            return {"embed_err": float("inf")}
        err = max(float((o.float() - ref).norm(dim=-1).max()) if o.shape == ref.shape
                  else float("inf") for o in self.outputs)
        return {"embed_err": err}
