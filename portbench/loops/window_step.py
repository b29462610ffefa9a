"""The window stage's closed loop: ``train/pretrain.py:window_train_step`` on
batches of fresh sequences, as ``-pretrain`` trains the window CNN (both
strands in one call, the f32 parity mode: TF32 off, convolutions off
cuDNN)."""

from __future__ import annotations

import copy

import torch

from portbench import flops
from portbench import traffic as gen_traffic
from portbench.loops import common
from portbench.reference import expecto, train

PREFIX = "model."  # NonStrandSpecific wraps the window model
TRAIN_STEP = ("chromegcn_tpu_torch.train.pretrain", "window_train_step")


def small(cfg: dict, traffic: dict):
    """The CPU tests' cut: sequences of 400 bp in batches of 4, a pool of 3
    batches; the widths stay. Copies; the arguments are left as they were."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(seq_length=400, batch_size=4)
    traffic["pool_batches"] = 3
    return cfg, traffic


class Session(common.StepSession):

    def setup(self, reuse=None) -> None:
        from chromegcn_tpu_torch.data.constants import SRC_VOCAB
        from chromegcn_tpu_torch.models.window import make_window_model
        from chromegcn_tpu_torch.ops.seq import complement_permutation
        from chromegcn_tpu_torch.train import pretrain as pt

        cfg = self.cfg
        if cfg["vocab"] != SRC_VOCAB:
            raise ValueError(f"the configuration's vocabulary {cfg['vocab']} is not the port's")
        model = make_window_model(cfg["model"], cfg["n_targets"], cfg["seq_length"],
                                  cfg["d_model"])
        opt = cfg["optimizer"]
        self.state = pt.create_window_state(model, opt["name"], opt["lr"], device=self.device)
        self.comp = torch.as_tensor(complement_permutation(SRC_VOCAB), device=self.device)
        draw = gen_traffic.device_generator(self.seed, self.device, 0)
        self.weights = common.make_weights(expecto.param_specs(cfg), draw, self.device)
        common.load_weights(self.state.model, self.weights, PREFIX)
        bases = [cfg["vocab"][b] for b in self.traffic["bases"]]
        self.batches = gen_traffic.window_batches(
            self.traffic["pool_batches"], cfg["batch_size"], cfg["seq_length"],
            cfg["n_targets"], cfg["positive_rate"], bases, draw, self.device)
        self.dropout_seed = gen_traffic.sub_seed(self.seed, 1)
        self.dropout = torch.Generator(device=self.device).manual_seed(self.dropout_seed)

        losses = []
        for i in range(self.CHECKED):
            losses.append(self.step(i))
            if i == 0:
                self.program["grad1"] = common.first_gradients(
                    self.state.model, self.state.optimizer, PREFIX)
        self.program["change"] = common.changes(self.state.model, self.weights, PREFIX)
        self.program["losses"] = [float(v) for v in losses]

    def step(self, i: int):
        from chromegcn_tpu_torch.train import pretrain as pt

        b = self.batches[i % len(self.batches)]
        _, loss, _ = pt.window_train_step(self.state, b["tokens"], b["targets"], b["row_mask"],
                                          self.comp, self.dropout, device=self.device)
        return loss

    def step_flops(self) -> float:
        return flops.window_step_flops(self.cfg)

    def free(self) -> None:
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype, tf32: bool = False, half_batch: bool = False) -> dict:
        loss = expecto.loss_fn(self.cfg, self.batches, self.dropout_seed, dtype, self.device,
                               half_batch)
        return train.sgd_steps(self.weights, loss, self.cfg["optimizer"], self.CHECKED, dtype,
                               tf32)
