"""The chromosome step's closed loop: ``train/finetune.py:chrome_train_step``
on one chromosome, step after step, as ``-load_pretrained`` trains each
chromosome of its split.

The graph goes through ``train/runner.py:build_split_graphs`` from a contact
file written with the port's saver, so the card's cost model picks the
operator form a user gets (``-spmm_form auto``). The features and targets
are the benchmark's, on the card: the runner's per-step copy of them from
the host is the finetune cell's to measure.
"""

from __future__ import annotations

import copy
import os
import tempfile
import types

import numpy as np
import torch

from portbench import flops
from portbench import traffic as gen_traffic
from portbench.loops import common
from portbench.reference import gcn, train

TRAIN_STEP = ("chromegcn_tpu_torch.train.finetune", "chrome_train_step")


def small(cfg: dict, traffic: dict):
    """The CPU tests' cut: a graph of 1,500 windows and 3,000 pairs; the
    widths stay. Copies; the arguments are left as they were."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    traffic["graph"].update(n_valid=1500, n_pairs=3000)
    return cfg, traffic


def runner_config(cfg: dict, root: str, **more):
    """The CLI's Config for this configuration, its files under ``root``."""
    from chromegcn_tpu_torch.config import Config

    return Config(dataroot=os.path.join(root, "data"), results_dir=os.path.join(root, "results"),
                  adj_type=cfg["adj_type"], hicnorm=cfg["hicnorm"], hicsize=str(cfg["hicsize"]),
                  spmm_form=cfg["spmm_form"], gcn_fused=cfg["gcn_fused"],
                  gcn_dropout=cfg["dropout"], gcn_layers=cfg["layers"], d_model=cfg["nfeat"],
                  optim=cfg["optimizer"]["name"], lr=cfg["optimizer"]["lr"],
                  matmul_precision="high", **more)


class Session(common.StepSession):

    def setup(self, reuse=None) -> None:
        """``reuse``: the ``edges`` and ``graph`` of an earlier setup of
        the same traffic, which ``calibrate.py`` builds once for all seeds."""
        from chromegcn_tpu_torch.data.artifact import save_graph_edges
        from chromegcn_tpu_torch.models.chrome import make_chrome_model
        from chromegcn_tpu_torch.train import finetune as ft
        from chromegcn_tpu_torch.train import runner

        cfg, g = self.cfg, self.traffic["graph"]
        self.n_valid = g["n_valid"]
        if reuse is None:
            self.edges = gen_traffic.graph_edges(g, g["seed"])
            with tempfile.TemporaryDirectory() as tmp:
                conf = runner_config(cfg, tmp)
                os.makedirs(conf.graph_root)
                save_graph_edges(conf.graph_path("train"), {"chr": self.edges})
                rows = {"chr": types.SimpleNamespace(forward=np.empty((self.n_valid, 0)))}
                self.graph = runner.build_split_graphs(conf, rows, "train", self.device,
                                                       verbose=lambda *_: None)["chr"]
        else:
            self.edges, self.graph = reuse.edges, reuse.graph
        self.n_pad = self.graph.n_nodes
        self.adjacency = gcn.adjacency(self.edges[0], self.edges[1], self.n_valid)
        self.nnz = len(self.adjacency[0])

        model = make_chrome_model("gcn", nclass=cfg["nclass"], dropout=cfg["dropout"],
                                  gate=cfg["gate"], layers=cfg["layers"], nfeat=cfg["nfeat"],
                                  spmm_impl="auto", fused=cfg["gcn_fused"])
        opt = cfg["optimizer"]
        self.state = ft.create_chrome_state(model, opt["name"], opt["lr"], device=self.device)
        # after the state, as run_finetune does it
        runner.apply_matmul_precision(runner_config(cfg, ""))
        draw = gen_traffic.device_generator(self.seed, self.device, 0)
        self.weights = common.make_weights(gcn.param_specs(cfg), draw, self.device)
        common.load_weights(model, self.weights)
        self.sets = gen_traffic.node_inputs(
            self.n_valid, self.n_pad, cfg["nfeat"], cfg["nclass"], cfg["positive_rate"],
            self.traffic["feature_sets"], draw, self.device)
        self.dropout_seed = gen_traffic.sub_seed(self.seed, 1)
        self.dropout = torch.Generator(device=self.device).manual_seed(self.dropout_seed)

        losses = []
        for i in range(self.CHECKED):
            losses.append(self.step(i))
            if i == 0:
                self.program["grad1"] = common.first_gradients(model, self.state.optimizer)
        self.program["change"] = common.changes(model, self.weights)
        self.program["losses"] = [float(v) for v in losses]

    def step(self, i: int):
        from chromegcn_tpu_torch.train import finetune as ft

        data = self.sets[i % len(self.sets)]
        _, loss, _ = ft.chrome_train_step(self.state, data["x_f"], data["x_r"], self.graph,
                                          data["targets"], self.dropout, device=self.device)
        return loss

    def step_flops(self) -> float:
        return flops.gcn_step_flops(self.cfg, self.n_valid, self.nnz)

    def sparse_product(self):
        """A @ x and its backward as the model calls them: ``ops/spmm.py``'s
        dispatch on this cell's graph, the backward through autograd."""
        from chromegcn_tpu_torch.ops.spmm import spmm

        impl = self.state.model.spmm_impl
        x = torch.randn(self.n_pad, self.cfg["nhid"], device=self.device, requires_grad=True)
        g = torch.randn(self.n_pad, self.cfg["nhid"], device=self.device)

        def product():
            torch.autograd.grad(spmm(self.graph, x, impl=impl), x, g)
        return product

    def free(self) -> None:
        self.state = self.graph = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype, tf32: bool = False, half_batch: bool = False) -> dict:
        graph = gcn.Graph(self.adjacency, self.n_valid, dtype, self.device)
        sets = [{k: v[:self.n_valid] for k, v in s.items()} for s in self.sets]
        loss = gcn.loss_fn(self.cfg, sets, graph, self.n_pad, self.dropout_seed, dtype,
                           self.device, half_batch)
        return train.sgd_steps(self.weights, loss, self.cfg["optimizer"], self.CHECKED, dtype,
                               tf32)
