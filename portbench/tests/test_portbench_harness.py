"""The harness on the CPU at tiny sizes: cells, configurations, mixes and
metrics found by name; the open loop's schedule and lateness; a tail over
every request and a rate over the whole window; the result line's keys.
One card test runs a real cell briefly (``-m cuda``; skips here)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _portbench_tiny as tiny
from portbench import core
from portbench import run as run_lib
from portbench.drivers import open_loop_search as serve_lib

REAL = core.Bench()


def test_every_cell_finds_its_files():
    for w in REAL.data['workloads']:
        REAL.cell(w['name'])
        c = REAL.config(w['config'])
        t = REAL.traffic(w['traffic'])
        assert set(REAL.limits(w['name'])['checks'])
        assert os.path.exists(run_lib.ROOT + '/portbench/drivers/' +
                              t['kind'] + '.py')
        assert c['name'] == w['config']
        for kind in ('end_to_end', 'per_layer'):
            for m in REAL.metrics(w['name'], kind):
                if kind == 'per_layer':
                    assert callable(REAL.reader(m['name']))


def test_each_metric_moves_a_metric_its_cells_report():
    e2e = {m['name']: m for m in REAL.data['end_to_end']}
    for m in REAL.data['per_layer']:
        moved = e2e[m['moves']]
        for cell in m['workloads']:
            assert cell in moved.get('workloads', [cell])


def test_every_cell_reports_setup_and_another_e2e_and_a_layer():
    for w in REAL.data['workloads']:
        names = [m['name'] for m in REAL.metrics(w['name'], 'end_to_end')]
        assert 'setup_s' in names and len(names) >= 2
        assert REAL.metrics(w['name'], 'per_layer')


def test_a_new_config_and_mix_are_found_without_editing(tmp_path):
    bench = tiny.make(tmp_path)
    pb = tmp_path / 'portbench'
    conf = json.loads((pb / 'configs' / 'tiny.json').read_text())
    conf['name'] = 'tiny-copy'
    (pb / 'configs' / 'tiny-copy.json').write_text(json.dumps(conf))
    mix = dict(tiny.TRAFFIC['tiny-test'], batch=4)
    (pb / 'traffic' / 'tiny-test4.json').write_text(json.dumps(mix))
    (pb / 'limits' / 't-new.json').write_text(json.dumps(
        {'checks': tiny.LIMITS['t-test']}))
    b = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    b['configs'].append({'name': 'tiny-copy', 'source': 'tiny',
                         'file': 'portbench/configs/tiny-copy.json',
                         'reduced': [], 'why': 'tiny'})
    b['workloads'].append({'name': 't-new', 'config': 'tiny-copy',
                           'traffic': 'tiny-test4', 'chips': 1,
                           'why': 'tiny'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    bench = core.Bench(tmp_path)
    r = run_lib.Run(tiny.args('t-new'), None, bench)
    assert r.config['name'] == 'tiny-copy' and r.traffic['batch'] == 4
    assert run_lib.driver(r).__name__.endswith('test_pass')


def test_arrivals_offer_the_same_gaps_in_another_order():
    a = serve_lib.arrivals(200.0, 10.0, 1)
    b = serve_lib.arrivals(200.0, 10.0, 2)
    assert len(a) == len(b) == 2000
    assert np.all(np.diff(a) > 0) and a[0] == 0 and a[-1] < 10.0
    ga, gb = (np.r_[np.diff(x), 10.0 - x[-1]] for x in (a, b))
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert not np.allclose(ga, gb)
    # exponential gaps: the mean is 1/rate, the median ln 2 / rate
    g = ga
    assert g.mean() == pytest.approx(1 / 200.0, rel=0.01)
    assert np.median(g) == pytest.approx(np.log(2) / 200.0, rel=0.05)


def test_lateness_counts_from_due_and_failures_as_missing():
    lat, lag = serve_lib.lateness([0.0, 1.0, 2.0], [0.1, 1.0, 2.5],
                                  [0.3, None, 3.0])
    assert lat[0] == pytest.approx(0.3) and lat[1] == float('inf')
    assert lat[2] == pytest.approx(1.0)
    assert lag == pytest.approx([0.1, 0.0, 0.5])


def test_p95_is_over_every_request():
    lat = list(np.arange(1, 101, dtype=float))
    assert core.percentile(lat, 95) == pytest.approx(95.05)
    # a request that failed is in the tail
    assert core.percentile(lat[:95] + [float('inf')] * 5, 95) == \
        float('inf')
    assert core.percentile([], 95) is None


@pytest.fixture(scope='module')
def bench(tmp_path_factory):
    tiny.cpu_threads()
    return tiny.make(tmp_path_factory.mktemp('tiny'))


@pytest.mark.parametrize('cell,trace', [('t-train', 0), ('t-test', 1),
                                        ('t-serve', 0)])
def test_the_result_line(bench, cell, trace):
    import torch
    out = run_lib.execute(tiny.args(cell, trace=trace), torch.device('cpu'),
                          bench)
    keys = list(out)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics',
                        'device']
    assert keys[-1] == 'checks'
    assert out['correct'] is True and out['failed'] == 0
    assert set(out['device']) >= {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    want = 'per_layer' if trace else 'end_to_end'
    names = {m['name'] for m in bench.metrics(cell, want)}
    assert set(out['metrics']) <= names
    if trace:
        assert 'breakdown' in out and 'window_s' in out['device']
    else:
        assert set(out['metrics']) == names
        assert out['metrics']['setup_s']['value'] > 0
    for c in out['checks'].values():
        assert set(c) == {'value', 'limit'}
    json.dumps(out)


def test_the_train_rate_is_over_the_whole_window(bench):
    import torch
    out = run_lib.execute(tiny.args('t-train', seconds=1.0),
                          torch.device('cpu'), bench)
    rec = out['record']
    assert rec['wall_s'] >= 1.0
    assert out['metrics']['train_imgs_per_s']['value'] == pytest.approx(
        rec['steps'] * rec['batch'] / rec['wall_s'])
    assert out['attempted'] == rec['steps']


def test_the_test_rate_counts_whole_passes(bench):
    import torch
    out = run_lib.execute(tiny.args('t-test', seconds=1.0),
                          torch.device('cpu'), bench)
    rec = out['record']
    assert out['metrics']['test_imgs_per_s']['value'] == pytest.approx(
        rec['passes'] * rec['imgs_per_pass'] / rec['wall_s'])
    assert rec['wall_s'] >= sum(rec['extract_s']) + sum(rec['eval_s'])


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    r = subprocess.run([sys.executable, '-m', 'portbench.run', '--workload',
                        REAL.data['workloads'][0]['name'], '--seed', '1',
                        '--seconds', '1'], cwd=run_lib.ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ''


def test_with_only_the_benchmark_the_run_fails(tmp_path):
    import shutil
    shutil.copy(os.path.join(run_lib.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(run_lib.ROOT, 'portbench'),
                    tmp_path / 'portbench')
    r = subprocess.run([sys.executable, '-m', 'portbench.run', '--workload',
                        REAL.data['workloads'][0]['name'], '--seed', '1',
                        '--seconds', '1'], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ''


@pytest.mark.cuda
def test_a_cell_runs_briefly_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cell = REAL.data['workloads'][0]['name']
    r = subprocess.run([sys.executable, '-m', 'portbench.run', '--workload',
                        cell, '--seed', '2718281828', '--seconds', '3'],
                       cwd=run_lib.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out['correct'] is True and out['device']['platform'] == 'gpu'
