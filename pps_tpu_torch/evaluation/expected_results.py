"""EXPECTED_RESULTS tolerance harness (a copy of
``pps_tpu/evaluation/expected_results.py``).

Entries are [dataset, task, metric, expected]; expected is a scalar
(checked with atol + rtol * |expected|) or a [mean, std] pair (checked
within EXPECTED_RESULTS_SIGMA_TOL sigmas).  The reference's scalar branch
inverts its comparison; this one uses the evidently intended
``err <= tol``, as the JAX package does.
"""

import logging

logger = logging.getLogger(__name__)


class ExpectedResultsError(AssertionError):
    pass


def check_expected_results(cfg, results, raise_on_fail=False):
    """Returns a list of failure messages (empty = all good)."""
    failures = []
    if not cfg.EXPECTED_RESULTS:
        return failures
    atol = cfg.EXPECTED_RESULTS_ATOL
    rtol = cfg.EXPECTED_RESULTS_RTOL
    for dataset, task, metric, expected in cfg.EXPECTED_RESULTS:
        for key, tree, what in ((dataset, results, 'Dataset'),
                                (task, results.get(dataset, {}), 'Task'),
                                (metric, results.get(dataset, {}).get(
                                    task, {}), 'Metric')):
            if key not in tree:
                raise KeyError('{} {} not in results'.format(what, key))
        actual = results[dataset][task][metric]
        if isinstance(expected, (list, tuple)):
            mean, std = expected
            lo = mean - cfg.EXPECTED_RESULTS_SIGMA_TOL * std
            hi = mean + cfg.EXPECTED_RESULTS_SIGMA_TOL * std
            ok = lo < actual < hi
            msg = ('{} > {} > {} sanity check (actual vs. expected): '
                   '{:.3f} vs. mean={:.4f}, std={:.4}, range=({:.4f}, '
                   '{:.4f})').format(dataset, task, metric, actual, mean,
                                     std, lo, hi)
        else:
            err = abs(actual - expected)
            tol = atol + rtol * abs(expected)
            ok = err <= tol
            msg = ('{} > {} > {} sanity check (actual vs. expected): '
                   '{:.3f} vs. {:.3f}, err={:.3f}, tol={:.3f}').format(
                       dataset, task, metric, actual, expected, err, tol)
        if ok:
            logger.info('PASS: %s', msg)
        else:
            logger.error('FAIL: %s', msg)
            failures.append(msg)
    if failures and getattr(cfg, 'EXPECTED_RESULTS_EMAIL', ''):
        import pprint
        from pps_tpu_torch.utils.logging import send_email
        send_email(
            'Expected results failure',
            '\n\n'.join(['Failures:', '\n'.join(failures),
                         'Config:', pprint.pformat(cfg)]),
            cfg.EXPECTED_RESULTS_EMAIL)
    if failures and raise_on_fail:
        raise ExpectedResultsError('; '.join(failures))
    return failures
