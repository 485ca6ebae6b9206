"""Scans completed in the window over the window's seconds (closed-loop
replay; the window ends in ``torch.cuda.synchronize()``)."""


def read(records):
    if records.get("mode") != "replay" or not records.get("window_s"):
        return None
    return records["scans"] / records["window_s"]
