"""Partitioned checkpoints across the two packages and across shard counts:
the JAX package's ``fit_partitioned`` on 8 CPU devices writes a checkpoint
that the port's resumes at 2 gloo ranks, at the epoch after its step; the
port's 2-rank run writes one that the JAX package resumes on 4 devices. One
group of ranks (tests/torch_dist_workers.py::checkpoint_checks).
"""

import numpy as np
import pytest
import torch

from tests import torch_dist_workers as W
from tpu_sage.data.synthetic import sbm_store as j_sbm_store
from tpu_sage.dist.mesh import make_mesh
from tpu_sage.dist.train import fit_partitioned as j_fit_partitioned
from tpu_sage.train.trainer import TrainConfig as JTrainConfig

PORT_WORLD = 2


def _jax_config(epochs):
    return JTrainConfig(batch_size=64, epochs=epochs, n_train_samples=(5, 3),
                        n_val_samples=(5, 3), output_dims=(32, 32), lr_init=0.01)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    out = tmp_path_factory.mktemp("ckpt")
    store = j_sbm_store(n_nodes=512, n_classes=4, feat_dim=16, avg_degree=6, seed=6)
    jax_recs = []
    _, _, jhist = j_fit_partitioned(store, _jax_config(2), mesh=make_mesh(), log=jax_recs.append,
                                    resume_from=str(out / "jax.npz"), checkpoint_every=1)
    W.spawn_ranks(W.checkpoint_checks, PORT_WORLD, str(out))
    port = torch.load(out / "rank0.pt", weights_only=False)
    back = []
    _, _, jhist2 = j_fit_partitioned(store, _jax_config(4), mesh=make_mesh(n_devices=4),
                                     log=back.append, resume_from=str(out / "port.npz"))
    return dict(out=out, jhist=jhist, port=port, back=back, jhist2=jhist2)


def test_port_resumes_the_jax_packages_checkpoint_on_another_shard_count(runs):
    jhist, port = runs["jhist"], runs["port"]
    assert jhist[-1]["n_shards"] == 8
    resumed = [r for r in port["resumed"] if "resumed_from" in r]
    assert resumed == [{"resumed_from": str(runs["out"] / "jax.npz"),
                        "step": 2 * (len(W.train_store().folds["train"]) // 64),
                        "start_epoch": 2}]
    hist = port["history"]
    assert [h["epoch"] for h in hist] == [2, 3] and hist[0]["n_shards"] == PORT_WORLD
    # training goes on from the 8-shard optimum, not from scratch
    assert hist[0]["train_loss"] < jhist[0]["train_loss"] * 0.9
    assert hist[-1]["val_metric"] > 0.5


def test_jax_package_resumes_the_ports_checkpoint(runs):
    port, back, jhist2 = runs["port"], runs["back"], runs["jhist2"]
    assert [h["epoch"] for h in port["history2"]] == [0, 1]
    assert {"checkpoint": str(runs["out"] / "port.npz"), "step": 2 * 4} in port["written"]
    assert any(r.get("resumed_from") == str(runs["out"] / "port.npz")
               and r.get("start_epoch") == 2 for r in back)
    assert [h["epoch"] for h in jhist2] == [2, 3] and jhist2[0]["n_shards"] == 4
    assert np.isfinite([h["train_loss"] for h in jhist2]).all()
    assert jhist2[0]["train_loss"] < port["history2"][0]["train_loss"] * 0.9
    assert jhist2[-1]["val_metric"] > 0.5
