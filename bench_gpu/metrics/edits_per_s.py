"""Edit throughput: edits completed in the window, each with its frame
finished on the card, over the window's length."""


def read(run):
    return run.records["edits"] / run.records["window_s"]
