"""setup_s: seconds from the process' start to the first timed step
(imports, the card, the inputs, any build, the warm-up steps)."""


def read(run):
    return run.setup_s
