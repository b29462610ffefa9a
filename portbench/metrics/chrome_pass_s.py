"""chrome_pass_s (s): host seconds in ``finetune.run_chrome_epoch`` per
epoch of the window (the three splits' passes, each ending in a copy to the
host), mean over the window's epochs."""


def read(session):
    return getattr(session, "spans", {}).get("run_chrome_epoch")
