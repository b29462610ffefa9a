"""The finetune mode's epochs: ``train/runner.py:run_finetune``
(``-load_pretrained``) over features and Hi-C contact files written from
the seed with the port's savers into a temporary directory.

The program is not edited: the benchmark wraps, for the run, the functions
the runner calls through their modules (``finetune.create_chrome_state``,
to hand the model the benchmark's weights; ``finetune.run_chrome_epoch``
and ``runner.compute_metrics``, to time them and keep what the check
reads), and its ``verbose`` callback sees each epoch end. The first epoch is
the warm-up; the window is the whole epochs after it, until the first epoch
end past the measured seconds (and past the third epoch, which the
reference follows).
"""

from __future__ import annotations

import copy
import os
import re
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import timing
from portbench import traffic as gen_traffic
from portbench.loops import common
from portbench.loops.chrome_step import runner_config
from portbench.reference import gcn, train
from portbench.reference import metrics as ref_metrics

EPOCH_END = re.compile(r"^epoch (\d+):")
BUCKET = 2048  # the runner pads each chromosome's rows to a multiple of this
TRAIN_STEP = ("chromegcn_tpu_torch.train.finetune", "chrome_train_step")


def small(cfg: dict, traffic: dict):
    """The CPU tests' cut: splits of 600 / 300 / 300 windows; the widths
    stay. Copies; the arguments are left as they were."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["splits"] = {"train": [600], "valid": [300], "test": [300]}
    return cfg, traffic


class StopWindow(Exception):
    """Raised from the runner's ``verbose`` callback to end the run."""


def padded(n: int) -> int:
    return -(-n // BUCKET) * BUCKET


class Session:
    CHECKED = 3

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.program: Dict[str, object] = {"losses": [], "observed": [], "preds": []}
        self.trace = None

    def write_world(self, conf) -> None:
        """Each split's one chromosome, of the configuration's size: N(0, 1)
        strand features and targets drawn on the card, contacts from
        make_hic_edges on the traffic's fixed graph seed (so every seed
        has the same sizes), written where the finetune mode reads them. The
        targets follow the features by one ``LabelRule`` for every split,
        drawn from the seed at the traffic's fixed ``label_scale``, so that
        every seed's model learns alike."""
        from chromegcn_tpu_torch.data.artifact import save_graph_edges
        from chromegcn_tpu_torch.data.loader import ChromFeatures, save_chrom_features

        cfg, t = self.cfg, self.traffic
        draw = gen_traffic.device_generator(self.seed, self.device, 0)
        self.weights = common.make_weights(gcn.param_specs(cfg), draw, self.device)
        rule = gen_traffic.LabelRule(cfg["nfeat"], cfg["nclass"], cfg["positive_rate"],
                                     t["label_scale"], draw, self.device)
        os.makedirs(conf.stage1_run_dir, exist_ok=True)
        os.makedirs(conf.graph_root, exist_ok=True)
        self.data = {}
        for k, (split, chrom) in enumerate(t["chromosomes"].items()):
            (n,) = cfg["splits"][split]
            x = torch.randn(2, n, cfg["nfeat"], generator=draw, device=self.device)
            y = rule.targets(x[0], x[1], draw)
            feats = ChromFeatures(forward=x[0].cpu().numpy(), backward=x[1].cpu().numpy(),
                                  target=y.cpu().numpy())
            edges = gen_traffic.make_hic_edges(
                n, int(round(t["pairs_per_window"] * n)),
                seed=gen_traffic.sub_seed(t["graph_seed"], k), power=t["power"],
                hubness=t["hubness"], compartment_frac=t["compartment_frac"])
            save_chrom_features(conf.feature_path(split), {chrom: feats})
            save_graph_edges(conf.graph_path(split), {chrom: edges})
            self.data[split] = (feats, edges)
        self.write_window_checkpoint(conf)

    def write_window_checkpoint(self, conf) -> None:
        """Stage 1's checkpoint, from which ``-load_pretrained`` warm-starts
        the GCN's head and its BatchNorm: the benchmark's head weights, and
        as running statistics those of the train split's features under the
        benchmark's weights (a trained window model's ``head_bn`` holds its
        features' statistics)."""
        from chromegcn_tpu_torch.train import checkpoint

        n, graph = self.graph_of("train", torch.float64)
        data = {k: v.double() for k, v in self.tensors("train").items()}
        w = {k: v.double() for k, v in self.weights.items()}
        mean, var = gcn.feature_stats(self.cfg, w, data, graph)
        self.stats_start = (mean, var)
        head = {"classifier.weight": self.weights["out.weight"],
                "classifier.bias": self.weights["out.bias"],
                "head_bn.weight": self.weights["batch_norm.weight"],
                "head_bn.bias": self.weights["batch_norm.bias"],
                "head_bn.running_mean": mean.float(), "head_bn.running_var": var.float()}
        checkpoint.save_checkpoint(conf.stage1_run_dir, {"model": head, "optimizer": {}}, 0)

    def graph_of(self, split: str, dtype):
        feats, edges = self.data[split]
        n = feats.forward.shape[0]
        return n, gcn.Graph(gcn.adjacency(edges[0], edges[1], n), n, dtype, self.device)

    def tensors(self, split: str) -> Dict[str, torch.Tensor]:
        feats = self.data[split][0]
        return {"x_f": torch.as_tensor(feats.forward, device=self.device),
                "x_r": torch.as_tensor(feats.backward, device=self.device),
                "targets": torch.as_tensor(feats.target, device=self.device)}

    def run(self, seconds: float, trace: bool, t_start: float) -> dict:
        from chromegcn_tpu_torch.train import finetune as ft
        from chromegcn_tpu_torch.train import runner

        tmp = tempfile.TemporaryDirectory()
        try:
            conf = runner_config(self.cfg, tmp.name, load_pretrained=True, epochs=1 << 30,
                                 seed=gen_traffic.sub_seed(self.seed, 1))
            self.dropout_seed = conf.seed
            self.write_world(conf)
            return self._run(conf, ft, runner, seconds, trace, t_start)
        finally:
            tmp.cleanup()

    def _run(self, conf, ft, runner, seconds, trace, t_start) -> dict:
        from chromegcn_tpu_torch.ops import _build

        spans: Dict[str, List[float]] = {}
        calls: List[dict] = []      # compute_metrics calls of the current epoch
        kept: List[List[dict]] = []  # the epochs whose metrics the check reads
        sample = np.random.default_rng(gen_traffic.sub_seed(self.seed, 3))
        clock = {"epoch": 1, "last": None, "start": None, "window_epochs": []}
        per_epoch = {"compute_metrics": [], "run_chrome_epoch": []}
        box = {}
        create, epoch_pass, metrics = (ft.create_chrome_state, ft.run_chrome_epoch,
                                       runner.compute_metrics)
        profiler = None

        def create_state(*a, **kw):
            state = create(*a, **kw)
            common.load_weights(state.model, self.weights)
            box["state"] = state
            return state

        def run_epoch(*a, **kw):
            t0 = time.perf_counter()
            out = epoch_pass(*a, **kw)
            spans.setdefault("run_chrome_epoch", []).append(time.perf_counter() - t0)
            if kw.get("train"):
                state = box["state"]
                self.program["losses"].append(out[3])
                if clock["epoch"] == 1:
                    self.program["grad1"] = common.first_gradients(state.model, state.optimizer)
                if clock["epoch"] == self.CHECKED:
                    self.program["change"] = common.changes(state.model, self.weights)
            return out

        def compute(preds, targs, loss, *a, **kw):
            t0 = time.perf_counter()
            out = metrics(preds, targs, loss, *a, **kw)
            spans.setdefault("compute_metrics", []).append(time.perf_counter() - t0)
            calls.append({"preds": preds, "targets": targs, "metrics": out})
            if len(calls) == 3:  # train, valid, test
                self.program["observed"].append(float(loss))
            return out

        def epoch_end(message, *_):
            nonlocal profiler
            m = EPOCH_END.match(str(message))
            if m is None:
                return
            now = time.perf_counter()
            epoch = int(m.group(1))
            for name in per_epoch:
                per_epoch[name].append(sum(spans.pop(name, [])))
            # the warm-up epoch's calls, and one window epoch's, drawn from
            # the seed as the epochs come (a reservoir of one)
            if epoch == 1:
                kept.append(list(calls))
            elif profiler is None and sample.random() < 1.0 / (epoch - 1):
                kept[1:] = [list(calls)]
            if epoch <= self.CHECKED:  # the valid and test passes' predictions
                self.program["preds"].append([calls[1]["preds"], calls[2]["preds"]])
            calls.clear()
            if epoch == 1:
                clock["setup_s"] = now - t_start
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                clock["start"] = now
            elif profiler is None:
                clock["window_epochs"].append(now - clock["last"])
            clock["last"] = now
            clock["epoch"] = epoch + 1
            if profiler is not None:
                profiler.stop()
                clock["profiled_s"] = now - clock["profile_start"]
                raise StopWindow
            if epoch >= self.CHECKED and now - clock["start"] >= seconds:
                clock["peak"] = (torch.cuda.max_memory_allocated(self.device)
                                 if self.device.type == "cuda" else 0)
                if not trace:
                    raise StopWindow
                profiler = torch.profiler.profile(activities=timing.activities(self.device))
                clock["launches"] = dict(_build.LAUNCHES)
                profiler.start()
                clock["profile_start"] = time.perf_counter()

        ft.create_chrome_state, ft.run_chrome_epoch = create_state, run_epoch
        runner.compute_metrics = compute
        try:
            runner.run_finetune(conf, device=self.device, verbose=epoch_end)
        except StopWindow:
            pass
        finally:
            ft.create_chrome_state, ft.run_chrome_epoch = create, epoch_pass
            runner.compute_metrics = metrics
        if "peak" not in clock:
            raise RuntimeError("the runner ended before the window closed")
        self.kept = kept
        epochs = clock["window_epochs"]
        n = len(epochs)
        self.spans = {name: float(np.mean(v[1:1 + n])) for name, v in per_epoch.items()}
        if profiler is not None:
            self.trace = timing.trace_of(profiler, clock["profiled_s"], clock["launches"])
        return {"setup_s": clock["setup_s"], "metrics": {"epoch_s": float(np.mean(epochs))},
                "attempted": n, "failed": 0, "peak_bytes": clock["peak"]}

    def free(self) -> None:
        """The program's state went with the runner's return."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype, tf32: bool = False, half_batch: bool = False) -> dict:
        """The reference's first steps; after each, as the runner's epoch
        does, the valid and test passes: their predictions (``preds``) and
        the test split's loss (``observed``)."""
        cfg = self.cfg
        n, graph = self.graph_of("train", dtype)
        evals = [(self.graph_of(split, dtype),
                  {k: v.to(dtype) for k, v in self.tensors(split).items()})
                 for split in ("valid", "test")]
        loss = gcn.loss_fn(cfg, [self.tensors("train")], graph, padded(n), self.dropout_seed,
                           dtype, self.device, half_batch, self.stats_start)
        preds = []

        def observe(w, i):
            with torch.no_grad():
                logits = [gcn.head_logits(cfg, w, data, g, padded(n_split), None, loss.stats,
                                          train=False)
                          for (n_split, g), data in evals]
                preds.append([torch.sigmoid(v) for v in logits])
                return float(gcn.bce(logits[1], evals[1][1]["targets"]))
        ref = train.sgd_steps(self.weights, loss, cfg["optimizer"], self.CHECKED, dtype, tf32,
                              observe)
        ref["preds"] = preds
        return ref

    def numbers(self, ref: dict, metrics_dtype=np.float64) -> Dict[str, float]:
        """The cell's numbers: the training gaps (the test split's eval
        losses among the losses, and the valid and test predictions of the
        first epochs) and the host metrics' largest gap over the kept
        epochs' calls."""
        program = dict(self.program)
        program["losses"] = program["losses"][:self.CHECKED]
        program["observed"] = program["observed"][:self.CHECKED]
        program["preds"] = program["preds"][:self.CHECKED]
        out = train.gaps(program, ref)
        out["metrics_gap"] = max(ref_metrics.gap(c["metrics"], c["preds"], c["targets"],
                                                 metrics_dtype)
                                 for epoch in self.kept for c in epoch)
        return out

    def check(self, limits: Dict[str, float]):
        return common.judge(self.numbers(self.reference(torch.float64)), limits)
