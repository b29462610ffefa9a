"""ChromeRNN's chromosome step in a closed loop:
``train/finetune.py:chrome_train_step`` on a ``make_chrome_model("rnn")``
state, step after step, as ``-load_pretrained -chrome_model rnn`` trains
each chromosome of its split.

The graph goes through ``train/runner.py:build_split_graphs`` from a contact
file written with the port's saver, as ``chrome_step.py`` gets it; ChromeRNN
reads only its node mask. The features and targets are the benchmark's, on
the card, padded with zero rows to the node bucket as the runner pads them.
"""

from __future__ import annotations

import copy
import os
import tempfile
import types

import numpy as np
import torch

from portbench import traffic as gen_traffic
from portbench.loops import chrome_step, common
from portbench.reference import rnn, train

TRAIN_STEP = ("chromegcn_tpu_torch.train.finetune", "chrome_train_step")


def small(cfg: dict, traffic: dict):
    """The CPU tests' cut: a chromosome of 1,500 windows (N_pad 2,048) and
    3,000 pairs; the widths stay. Copies; the arguments are left as they
    were."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    traffic["graph"].update(n_valid=1500, n_pairs=3000)
    return cfg, traffic


def step_flops(cfg: dict, n_pad: int, n_valid: int) -> float:
    """Forward and backward operations of one ``chrome_train_step``: per
    strand, layer and direction, 2 x 4H (in + H) a position over all N_pad
    positions (the padded ones are part of the sequence), three times (the
    forward, the input gradients and the weight gradients); the head once
    over the valid rows' strand mean, three times."""
    h, lstm = cfg["hidden"], 0
    for layer in range(cfg["layers"]):
        fan_in = cfg["nfeat"] if layer == 0 else 2 * h
        lstm += 3 * 2 * (2 * 4 * h * (fan_in + h)) * n_pad
    head = 3 * 2 * n_valid * 2 * h * cfg["nclass"]
    return float(cfg["strands"] * lstm + head)


class Session(common.StepSession):

    def setup(self, reuse=None) -> None:
        """``reuse``: the ``edges`` and ``graph`` of an earlier setup of
        the same traffic, which ``calibrate.py`` builds once for all seeds."""
        from chromegcn_tpu_torch.data.artifact import save_graph_edges
        from chromegcn_tpu_torch.models.chrome import make_chrome_model
        from chromegcn_tpu_torch.train import finetune as ft
        from chromegcn_tpu_torch.train import runner

        cfg, g = self.cfg, self.traffic["graph"]
        if cfg["hidden"] * 2 != cfg["nfeat"]:
            raise ValueError("ChromeRNN's hidden size is nfeat // 2")
        self.n_valid = g["n_valid"]
        if reuse is None:
            self.edges = gen_traffic.graph_edges(g, g["seed"])
            with tempfile.TemporaryDirectory() as tmp:
                conf = chrome_step.runner_config(cfg, tmp, chrome_model=cfg["model"])
                os.makedirs(conf.graph_root)
                save_graph_edges(conf.graph_path("train"), {"chr": self.edges})
                rows = {"chr": types.SimpleNamespace(forward=np.empty((self.n_valid, 0)))}
                self.graph = runner.build_split_graphs(conf, rows, "train", self.device,
                                                       verbose=lambda *_: None)["chr"]
        else:
            self.edges, self.graph = reuse.edges, reuse.graph
        self.n_pad = self.graph.n_nodes

        model = make_chrome_model(cfg["model"], nclass=cfg["nclass"], dropout=cfg["dropout"],
                                  layers=cfg["layers"], nfeat=cfg["nfeat"])
        opt = cfg["optimizer"]
        self.state = ft.create_chrome_state(model, opt["name"], opt["lr"], device=self.device)
        # after the state, as run_finetune does it
        runner.apply_matmul_precision(chrome_step.runner_config(cfg, ""))
        draw = gen_traffic.device_generator(self.seed, self.device, 0)
        self.weights = common.make_weights(rnn.param_specs(cfg), draw, self.device)
        self.fixed = common.make_weights(rnn.fixed_specs(cfg), draw, self.device)
        common.load_weights(model, self.weights)
        held = dict(model.named_parameters())
        with torch.no_grad():
            for name, value in self.fixed.items():
                held[name].copy_(value)
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
        return step_flops(self.cfg, self.n_pad, self.n_valid)

    def free(self) -> None:
        self.state = self.graph = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype, tf32: bool = False, half_batch: bool = False) -> dict:
        sets = [dict(s, targets=s["targets"][:self.n_valid]) for s in self.sets]
        loss = rnn.loss_fn(self.cfg, sets, self.n_valid, self.fixed, self.dropout_seed, dtype,
                           self.device, half_batch)
        return train.sgd_steps(self.weights, loss, self.cfg["optimizer"], self.CHECKED, dtype,
                               tf32)
