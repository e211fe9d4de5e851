"""The test driver with ``REID.RERANK`` and ``REID.VIS`` at a tiny size:
``run_inference`` of the port (on the CPU: the host C++ re-rank engine)
and of pps_tpu (its numpy re-rank path; its own C++ library is neither
built nor loaded here) from one weights pkl; and the CUHK03 _rerank yaml
through the port's test_net CLI.

Tolerances.  The printed lines (percentages to two decimals) must be
equal, and the result dicts within 1e-6: the features agree to float32
rounding (tests/test_torch_port_model.py's bound) and the re-ranked
distances to 1e-5, far from moving a rank on this set.  The rank-list
images come from the same numpy distance matrix through the same cv2
calls, so they are held byte for byte.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pps_tpu.native
from pps_tpu.data import catalog as jcatalog
from pps_tpu.engine import test as jtest_engine
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.data.transforms import _cv2
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import test as ttest_engine
from pps_tpu_torch.models.model import build_model as tbuild

from test_torch_port_data import both_cfgs, decoder, write_coco
from test_torch_port_evaluation import N_IDS, TINY

METRIC_ATOL = 1e-6
REPO = Path(__file__).resolve().parents[1]
RERANK_YAML = REPO / 'configs' / 'cuhk03' / 'pps_crm_triplet_R-50_1x_rerank.yaml'


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _two_threads_no_pps_tpu_native(monkeypatch):
    monkeypatch.setattr(pps_tpu.native, 'available', lambda: False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()
    torch.set_num_threads(n)


def test_run_inference_rerank_and_vis_match(tmp_path, capsys):
    imdir, ann = write_coco(tmp_path, 'test', N_IDS, 5, hw=(48, 20),
                            with_marks=True, n_cams=3)
    dec = decoder((48, 20))
    cv2 = _cv2()
    with open(ann) as f:  # the rank-list images read the files
        for im in json.load(f)['images']:
            cv2.imwrite(os.path.join(imdir, im['file_name']),
                        dec(im['file_name']))
    for cat in (jcatalog, tcatalog):
        cat.register_dataset('port_eval_test', imdir, ann)
    jc, tc = both_cfgs(TINY + ['REID.RERANK', 'True', 'REID.VIS', 'True'])
    model = tbuild(tc, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    weights = str(tmp_path / 'weights.pkl')
    tckpt.save_checkpoint(weights, model, params, state)

    want = jtest_engine.run_inference(jc, weights, str(tmp_path / 'j'),
                                      decode_fn=dec)['port_eval_test']
    want_out = capsys.readouterr().out
    got = ttest_engine.run_inference(tc, weights, str(tmp_path / 't'),
                                     decode_fn=dec,
                                     device='cpu')['port_eval_test']
    got_out = capsys.readouterr().out

    lines = [ln for ln in got_out.splitlines() if '[mAP:' in ln]
    assert [ln.split('[')[0].strip() for ln in lines] == [
        'Single Query:', 'Re-ranked Single Query:']
    assert lines == [ln for ln in want_out.splitlines() if '[mAP:' in ln]
    assert sorted(got) == sorted(want) == ['single', 'single_rerank']
    for block in want:
        for key in ('mAP', 'cmc1', 'cmc5', 'cmc10'):
            np.testing.assert_allclose(got[block][key], want[block][key],
                                       rtol=0, atol=METRIC_ATOL)
    jvis, tvis = tmp_path / 'j' / 'vis', tmp_path / 't' / 'vis'
    names = sorted(os.listdir(str(tvis)))
    assert names and names == sorted(os.listdir(str(jvis)))
    for name in names:
        assert (tvis / name).read_bytes() == (jvis / name).read_bytes()
        im = cv2.imread(str(tvis / name))
        assert im.shape[0] == 48 + 8 and im.shape[2] == 3


def test_cli_test_net_rerank_yaml_on_cpu(tmp_path):
    """``python -m pps_tpu_torch.tools.test_net --device cpu`` on the CUHK03
    _rerank yaml cut to a tiny size: the split from $PPS_TPU_DATA_DIR
    (cuhk03/labeled/), decoded from image files; prints the single-query
    and re-ranked lines and exits 0."""
    root = tmp_path / 'data' / 'cuhk03' / 'labeled'
    imdir, ann = write_coco(root, 'test', N_IDS, 5, hw=(48, 20),
                            with_marks=True, n_cams=2)
    dec = decoder((48, 20))
    cv2 = _cv2()
    with open(ann) as f:
        for im in json.load(f)['images']:
            cv2.imwrite(os.path.join(imdir, im['file_name']),
                        dec(im['file_name']))
    opts = ['MODEL.DTYPE', 'float32', 'REID.SCALE', '(32, 96)',
            'TEST.IMS_PER_BATCH', '8']
    tcfg.merge_cfg_from_file(str(RERANK_YAML))
    tcfg.merge_cfg_from_list(opts)
    model = tbuild(tcfg.cfg, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    weights = str(tmp_path / 'weights.pkl')
    tckpt.save_checkpoint(weights, model, params, state)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2',
               PPS_TPU_DATA_DIR=str(tmp_path / 'data'))
    r = subprocess.run(
        [sys.executable, '-m', 'pps_tpu_torch.tools.test_net', '--device',
         'cpu', '--cfg', str(RERANK_YAML), 'TEST.WEIGHTS', weights,
         'OUTPUT_DIR', str(tmp_path / 'out'), *opts],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if '[mAP:' in ln]
    assert [ln.split('[')[0].strip() for ln in lines] == [
        'Single Query:', 'Re-ranked Single Query:']
    assert (tmp_path / 'out' / 'test' / 'cuhk03_test' /
            'features.pkl').exists()
