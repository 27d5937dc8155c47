"""The port's VQA-v2 ETL (vqa_tpu_torch.{datahelper,prepare_data}) vs vqa_tpu's.

On the same synthetic VQA-v2 annotation/question JSON (written here from a
seed, in the shape of tests/test_prepare_data.py's fixture), the port's CLI
writes byte-identical ``.txt`` files and vocab pickles that load to equal
dicts, and its ``VQA`` index answers every query as vqa_tpu's does.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from vqa_tpu import datahelper as j_datahelper
from vqa_tpu import prepare_data as j_prepare
from vqa_tpu_torch import datahelper as t_datahelper
from vqa_tpu_torch import prepare_data as t_prepare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["what", "is", "the", "color", "of", "cat", "dog", "how", "many", "Is", "there",
         "a", "bed", "on", "table?", "man's", "hat", "red,", "blue"]
ANSWERS = ["yes", "no", "2", "red", "cat", "blue", "zero"]
QTYPES = ["what is", "is the", "how many", "what color"]
ATYPES = ["other", "yes/no", "number"]


@pytest.fixture(scope="module")
def vqa_json(tmp_path_factory):
    """Annotations + questions for 9 images (COCO-sized and small ids), 1-3
    questions each, with irregular whitespace in the questions."""
    root = tmp_path_factory.mktemp("vqa_json")
    rng = np.random.default_rng(3)
    image_ids = [25, 7777, 9, 123456, 581929, 42, 100000, 3, 65]
    anns, ques = [], []
    for img in image_ids:
        for _ in range(int(rng.integers(1, 4))):
            qid = img * 10 + len(anns)
            words = [WORDS[int(j)] for j in rng.integers(0, len(WORDS), rng.integers(2, 8))]
            question = ("  " if qid % 3 == 0 else "") + "  ".join(words) + \
                (" \t" if qid % 2 else "")
            ans = ANSWERS[int(rng.integers(len(ANSWERS)))]
            anns.append({"image_id": img, "question_id": qid,
                         "question_type": QTYPES[qid % 4], "answer_type": ATYPES[qid % 3],
                         "multiple_choice_answer": ans,
                         "answers": [{"answer": ans, "answer_id": 1},
                                     {"answer": ANSWERS[qid % 7], "answer_id": 2}]})
            ques.append({"question_id": qid, "image_id": img, "question": question,
                         "multiple_choices": ANSWERS})
    header = {"info": {"version": "2.0", "year": 2017}, "task_type": "Multiple Choice",
              "data_type": "mscoco", "data_subtype": "train2014", "license": {"name": "x"}}
    a, q = root / "annotations.json", root / "questions.json"
    a.write_text(json.dumps({**header, "annotations": anns}))
    q.write_text(json.dumps({**header, "questions": ques}))
    return str(a), str(q), anns


@pytest.mark.parametrize("split,source", [("train", "--balanced_real_images"),
                                          ("val", "--balanced_real_images"),
                                          ("train", "--abstract_scene_images")])
def test_etl_files_byte_identical(vqa_json, tmp_path, split, source):
    a, q, anns = vqa_json
    outs = {}
    for name, prepare in (("jax", j_prepare), ("port", t_prepare)):
        txt, voc = tmp_path / f"{name}.txt", tmp_path / f"{name}.pkl"
        prepare.main([source, "-s", split, "-a", a, "-q", q, "-o", str(txt),
                      "-v", str(voc), "-c", "2", "-K", "4"])
        outs[name] = (txt.read_bytes(), voc.read_bytes())
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][0].count(b"\n") == len(anns)
    assert pickle.loads(outs["port"][1]) == pickle.loads(outs["jax"][1])


def test_abstract_val_raises_as_vqa_tpu(vqa_json, tmp_path):
    a, q, _ = vqa_json
    for prepare in (j_prepare, t_prepare):
        with pytest.raises(NotImplementedError):
            prepare.main(["--abstract_scene_images", "-s", "val", "-a", a, "-q", q,
                          "-o", str(tmp_path / "x.txt")])
    assert t_prepare.image_affixes("val", True, False) == j_prepare.image_affixes(
        "val", True, False)
    for n in (0, 9, 123456):
        for real in (True, False):
            assert t_prepare.coco_pad(n, real) == j_prepare.coco_pad(n, real)


def test_module_cli_runs(vqa_json, tmp_path):
    """``python -m vqa_tpu_torch.prepare_data`` as a user runs it."""
    a, q, _ = vqa_json
    out = tmp_path / "train.txt"
    subprocess.run([sys.executable, "-m", "vqa_tpu_torch.prepare_data", "--balanced_real_images",
                    "-s", "train", "-a", a, "-q", q, "-o", str(out)],
                   cwd=REPO, check=True, capture_output=True, timeout=120)
    first = out.read_text().splitlines()[0].split("\t")
    assert first[0] == "COCO_train2014_000000000025.jpg" and len(first) == 3


QUERIES = [
    ("getQuesIds", {}), ("getQuesIds", {"imgIds": [25, 9]}), ("getQuesIds", {"imgIds": 7777}),
    ("getQuesIds", {"quesTypes": ["is the"]}), ("getQuesIds", {"ansTypes": "yes/no"}),
    ("getQuesIds", {"imgIds": [42, 3], "quesTypes": ["what is", "how many"],
                    "ansTypes": ["other", "number"]}),
    ("getImgIds", {}), ("getImgIds", {"quesTypes": "what color"}),
    ("getImgIds", {"ansTypes": ["number"]}),
]


@pytest.mark.parametrize("method,kw", QUERIES, ids=lambda v: str(v) if isinstance(v, dict) else v)
def test_vqa_queries_agree(vqa_json, method, kw):
    a, q, _ = vqa_json
    j, t = j_datahelper.VQA(a, q), t_datahelper.VQA(a, q)
    assert getattr(t, method)(**kw) == getattr(j, method)(**kw)


def test_vqa_load_show_and_results_agree(vqa_json, tmp_path, capsys):
    a, q, anns = vqa_json
    j, t = j_datahelper.VQA(a, q), t_datahelper.VQA(a, q)
    assert t.qqa == j.qqa and t.imgToQA == j.imgToQA
    qids = t.getQuesIds()
    assert t.loadQA(qids[3]) == j.loadQA(qids[3])
    assert t.loadQA(qids[:5]) == j.loadQA(qids[:5])
    capsys.readouterr()
    j.showQA(j.loadQA(qids[:3]))
    shown = capsys.readouterr().out
    t.showQA(t.loadQA(qids[:3]))
    assert capsys.readouterr().out == shown and "Question:" in shown
    # a results file in the official format: one answer per question
    res = tmp_path / "res.json"
    res.write_text(json.dumps([{"question_id": i, "answer": ANSWERS[i % 7]} for i in qids]))
    rj, rt = j.loadRes(str(res), q), t.loadRes(str(res), q)
    assert rt.dataset == rj.dataset and rt.qa == rj.qa and rt.imgToQA == rj.imgToQA
    # an incomplete one is refused by both (vqa_tpu asserts, the port raises)
    res.write_text(json.dumps([{"question_id": i, "answer": "yes"} for i in qids[1:]]))
    with pytest.raises(AssertionError, match="do not match"):
        j.loadRes(str(res), q)
    with pytest.raises(ValueError, match="do not match"):
        t.loadRes(str(res), q)
    # so is an answer outside a multiple-choice question's choices
    res.write_text(json.dumps([{"question_id": i, "answer": "purple"} for i in qids]))
    with pytest.raises(AssertionError, match="multiple choices"):
        j.loadRes(str(res), q)
    with pytest.raises(ValueError, match="multiple choices"):
        t.loadRes(str(res), q)
