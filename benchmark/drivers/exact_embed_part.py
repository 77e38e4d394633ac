"""Exact embeddings of every node over a node-sharded graph, one rank a
card: ``nn/full_graph.py::embed_all_nodes_partitioned``, whose every chunk
fetches its neighbour rows through the exact halo exchange
(``dist/halo.py::dist_gather``), passes back to back. Work: the nodes each
pass embeds over the whole group.

Every rank makes the same graph on its own card from the seed, as
``exact_embed.py`` does, and keeps its contiguous shard in the layout of
``dist/partition.py``: ``m = ceil(n / ranks)`` rows of the adjacency (global
ids), the degrees and the features from row ``rank · m``, the rows past
``n`` padding of degree 0. The weights come from the same seed. Each rank
compares its own nodes' rows of the window's first and last pass with the
reference's rows of those nodes."""

from __future__ import annotations

import os

import torch

from benchmark import files

exact_embed = files.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                              "exact_embed.py"))


class Session(exact_embed.Session):

    def _program_graph(self):
        """This rank's shard of the inputs."""
        from tpu_sage_torch.dist import mesh
        from tpu_sage_torch.graph.graph_data import DeviceGraph

        n = self.graph_spec["n_nodes"]
        m = -(-n // mesh.world())
        start = mesh.rank() * m
        lo, hi = min(start, n), min(start + m, n)
        self.owned = slice(lo, hi)
        inp = self.inputs
        pad = torch.arange(start + hi - lo, start + m, dtype=torch.int32, device=inp.adj.device)
        zero_rows = inp.feats.new_zeros((len(pad), inp.feats.shape[1]))
        return DeviceGraph(
            adj=torch.cat([inp.adj[lo:hi], pad[:, None].expand(-1, inp.adj.shape[1])]),
            degrees=torch.cat([inp.degrees[lo:hi], torch.zeros_like(pad)]),
            feats=torch.cat([inp.feats[lo:hi], zero_rows]),
            targets=torch.cat([inp.labels[lo:hi], torch.zeros_like(pad)]))

    def _pass(self) -> torch.Tensor:
        from tpu_sage_torch.nn.full_graph import embed_all_nodes_partitioned

        out = embed_all_nodes_partitioned(self.model, self.graph, chunk=self.chunk)
        return out[:self.owned.stop - self.owned.start]

    def reference(self, precision: str = "float32") -> torch.Tensor:
        return super().reference(precision)[self.owned]
