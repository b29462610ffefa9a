"""Small sizes of the cells for the CPU tests."""


def small(cell: str):
    """(config, traffic) of ``cell`` cut to a size the CPU runs in seconds,
    by its loop's ``small``: the widths stay, the rows, sequence length and
    batch shrink."""
    from portbench import harness

    manifest = harness.load_manifest()
    entry = harness.cell_entry(manifest, cell)
    cfg = harness.load_json("configs", entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    cut = getattr(harness.loop_module(traffic["loop"]), "small", None)
    if cut is None:
        raise ValueError(f"loops/{traffic['loop']}.py has no small(cfg, traffic), which cuts "
                         f"{cell} to the CPU tests' size")
    return cut(cfg, traffic)
