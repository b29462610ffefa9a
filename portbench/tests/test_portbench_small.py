"""Each loop declares what the tests need of it: ``small``, the cut of its
cells to the CPU tests' size, and ``TRAIN_STEP``, the program's function
one step runs. ``small`` gives the sizes the CPU tests have run since the
benchmark began, keeps the widths and leaves its arguments as they were; a
loop without it is named, never run at full size."""

import copy
import importlib

import pytest

from portbench import harness
from portbench.loops import chrome_step

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def graph_cut(cfg, traffic):
    traffic["graph"].update(n_valid=1500, n_pairs=3000)


def window_cut(cfg, traffic):
    cfg.update(seq_length=400, batch_size=4)
    traffic["pool_batches"] = 3


def splits_cut(cfg, traffic):
    cfg["splits"] = {"train": [600], "valid": [300], "test": [300]}


# what each cell's cut changes in its full-size files
CUTS = {"gcn_chr1_step": graph_cut, "gcn_chr1_nohub_step": graph_cut,
        "expecto_step": window_cut, "gcn_finetune_rule_epoch": splits_cut}


def full(cell):
    entry = harness.cell_entry(harness.load_manifest(), cell)
    return harness.load_json("configs", entry["config"]), harness.load_json("traffic",
                                                                            entry["traffic"])


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_each_loop_cuts_its_cells_to_the_tests_sizes(cell, small_cell):
    cfg, traffic = full(cell)
    before = copy.deepcopy((cfg, traffic))
    got = harness.loop_module(traffic["loop"]).small(cfg, traffic)
    assert (cfg, traffic) == before
    assert got[0] is not cfg and got[1] is not traffic
    CUTS[cell](cfg, traffic)
    assert got == (cfg, traffic)
    assert small_cell(cell) == got


def test_a_loop_without_small_is_named(small_cell, monkeypatch):
    monkeypatch.delattr(chrome_step, "small")
    with pytest.raises(ValueError, match=r"loops/chrome_step\.py has no small"):
        small_cell("gcn_chr1_step")


@pytest.mark.parametrize("cell", CELLS)
def test_every_loop_declares_what_the_tests_need(cell):
    loop = harness.loop_module(full(cell)[1]["loop"])
    assert callable(loop.Session) and callable(loop.small)
    module_name, fn_name = loop.TRAIN_STEP
    module = importlib.import_module(module_name)
    # the fault tests wrap the step and patch the loss it calls
    assert callable(getattr(module, fn_name)) and callable(module.bce_with_logits)
