"""Per cent of the window's steps that took their batch with the loader's
queue empty (``ReIDLoader.qsize()`` 0): the step waited for decodes."""


def read(run):
    steps = run.record.get('steps')
    return 100.0 * run.record['starved'] / steps if steps else None
