"""Plain-PyTorch GraphSAGE baseline for the edges/s denominator (counterpart
of ``tpu_sage/bench/torch_baseline.py``).

The reference's hot loop in plain PyTorch, with no kernel of the port:
uniform column sampling over a random padded adjacency, feature gather,
2-layer mean aggregation (concat of self/neighbor projections + ReLU), L2
normalize, linear head, CE loss, backward, Adam step. It runs on ``device``
(the card by default) with an explicit generator, synchronizes before every
clock read, and reports the device it ran on::

    python -m tpu_sage_torch.bench.torch_baseline            # the card
    python -m tpu_sage_torch.bench.torch_baseline --device cpu --n-nodes 5000
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchMeanAgg(nn.Module):
    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.fc_self = nn.Linear(input_dim, output_dim, bias=False)
        self.fc_neigh = nn.Linear(input_dim, output_dim, bias=False)

    def forward(self, x_self, x_neigh, act=True):
        out = torch.cat(
            [self.fc_self(x_self), self.fc_neigh(x_neigh.mean(dim=1))], dim=-1
        )
        return F.relu(out) if act else out


class TorchGraphSAGE(nn.Module):
    def __init__(self, feat_dim, hidden, n_classes):
        super().__init__()
        self.agg1 = TorchMeanAgg(feat_dim, hidden)
        self.agg2 = TorchMeanAgg(2 * hidden, hidden)
        self.fc = nn.Linear(2 * hidden, n_classes)

    def forward(self, levels_feats, fanouts):
        h = list(levels_feats)
        for li, agg in enumerate([self.agg1, self.agg2]):
            nxt = []
            act = li == 0
            for d in range(len(h) - 1):
                n_self = h[d].shape[0]
                x_neigh = h[d + 1].reshape(n_self, -1, h[d + 1].shape[-1])
                nxt.append(agg(h[d], x_neigh, act=act))
            h = nxt
        out = F.normalize(h[0], dim=-1)
        return self.fc(out)


def run(
    n_nodes=232_965,
    feat_dim=602,
    n_classes=41,
    max_degree=128,
    batch_size=512,
    fanouts=(25, 10),
    hidden=128,
    steps=30,
    warmup=5,
    seed=0,
    device="cuda",
):
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("device cuda needs a CUDA card; pass device='cpu' for the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    adj = torch.from_numpy(
        rng.integers(0, n_nodes, size=(n_nodes, max_degree)).astype(np.int64)
    ).to(device)
    feats = torch.from_numpy(
        rng.normal(size=(n_nodes, feat_dim)).astype(np.float32)).to(device)
    labels = torch.from_numpy(
        rng.integers(0, n_classes, size=n_nodes).astype(np.int64)).to(device)

    torch.manual_seed(seed)  # nn.Linear's default init draws from the global generator
    model = TorchGraphSAGE(feat_dim, hidden, n_classes).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def step():
        ids = torch.randint(0, n_nodes, (batch_size,), generator=gen, device=device)
        levels = [ids]
        for f in fanouts:
            cur = levels[-1]
            cols = torch.randint(0, max_degree, (cur.shape[0], f), generator=gen,
                                 device=device)
            nbr = adj[cur.unsqueeze(1), cols]
            levels.append(nbr.reshape(-1))
        levels_feats = [feats[lv] for lv in levels]
        logits = model(levels_feats, fanouts)
        loss = F.cross_entropy(logits, labels[ids])
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(warmup):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    sync()
    dt = time.perf_counter() - t0

    f1, f2 = fanouts
    edges_per_step = batch_size * (f1 + f1 * f2)
    return {
        "edges_per_sec": steps * edges_per_step / dt,
        "steps_per_sec": steps / dt,
        "ms_per_step": dt / steps * 1e3,
        "edges_per_step": edges_per_step,
        "loss_finite": bool(torch.isfinite(loss).item()),
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "torch_version": torch.__version__,
        "config": {
            "n_nodes": n_nodes, "feat_dim": feat_dim, "batch_size": batch_size,
            "fanouts": list(fanouts), "hidden": hidden, "steps": steps,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-nodes", type=int, default=232_965)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    print(json.dumps(run(n_nodes=args.n_nodes, steps=args.steps, device=args.device)))


if __name__ == "__main__":
    main()
