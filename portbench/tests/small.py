"""Small sizes of the cells for the CPU tests."""


def small(cell: str):
    """(config, traffic) of ``cell`` cut to a size the CPU runs in seconds:
    the widths stay, the rows, sequence length and batch shrink."""
    from portbench import harness

    manifest = harness.load_manifest()
    entry = harness.cell_entry(manifest, cell)
    cfg = harness.load_json("configs", entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    if traffic["loop"] == "chrome_step":
        traffic["graph"].update(n_valid=1500, n_pairs=3000)
    elif traffic["loop"] == "window_step":
        cfg.update(seq_length=400, batch_size=4)
        traffic["pool_batches"] = 3
    else:
        cfg["splits"] = {"train": [600], "valid": [300], "test": [300]}
    return cfg, traffic
