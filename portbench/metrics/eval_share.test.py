"""Per cent of a test pass spent in ``engine/test.evaluate_dataset``
(distance matrix, CMC and mAP), host clock with the card synchronised,
over the passes before the traced one."""


def read(run):
    share = run.record.get('eval_share')
    return None if share is None else 100.0 * share
