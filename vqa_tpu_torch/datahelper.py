"""VQA-v2 annotation/question JSON index (the port's copy of vqa_tpu/datahelper.py).

The index the reference ships (datahelper.py:26-183, derived from the
public GT-Vision-Lab VQA helper), with the same public query surface:
``getQuesIds``, ``getImgIds``, ``loadQA``, ``showQA`` and ``loadRes`` (a
results file in the official evaluation format). Pure Python.

The ETL (``vqa_tpu_torch.prepare_data``) reads ``dataset['annotations']``
and ``qqa`` only; the rest is the query surface, kept for drop-in use. A
results file that does not match the index raises ``ValueError`` (vqa_tpu
asserts, which ``python -O`` would drop).
"""

from __future__ import annotations

import copy
import json
import time


def _as_list(x):
    return x if isinstance(x, list) else [x]


class VQA:
    """Index over VQA annotation + question JSON files."""

    def __init__(self, annotation_file: str | None = None, question_file: str | None = None):
        self.dataset: dict = {}
        self.questions: dict = {}
        self.qa: dict = {}       # question_id -> annotation
        self.qqa: dict = {}      # question_id -> question record
        self.imgToQA: dict = {}  # image_id -> [annotations]
        if annotation_file and question_file:
            print("loading VQA annotations and questions into memory...")
            t0 = time.time()
            with open(annotation_file, "r") as f:
                self.dataset = json.load(f)
            with open(question_file, "r") as f:
                self.questions = json.load(f)
            print(f"{time.time() - t0:.2f}s")
            self.createIndex()

    def createIndex(self) -> None:
        print("creating index...")
        anns = self.dataset["annotations"]
        self.imgToQA = {}
        self.qa = {}
        for ann in anns:
            self.imgToQA.setdefault(ann["image_id"], []).append(ann)
            self.qa[ann["question_id"]] = ann
        self.qqa = {q["question_id"]: q for q in self.questions["questions"]}
        print("index created!")

    def info(self) -> None:
        for key, value in self.dataset.get("info", {}).items():
            print(f"{key}: {value}")

    def getQuesIds(self, imgIds=[], quesTypes=[], ansTypes=[]):
        """Question ids matching the given image-id / type filters."""
        imgIds, quesTypes, ansTypes = _as_list(imgIds), _as_list(quesTypes), _as_list(ansTypes)
        if not (imgIds or quesTypes or ansTypes):
            anns = self.dataset["annotations"]
        else:
            if imgIds:
                anns = [a for i in imgIds for a in self.imgToQA.get(i, [])]
            else:
                anns = self.dataset["annotations"]
            if quesTypes:
                anns = [a for a in anns if a["question_type"] in quesTypes]
            if ansTypes:
                anns = [a for a in anns if a["answer_type"] in ansTypes]
        return [a["question_id"] for a in anns]

    def getImgIds(self, quesIds=[], quesTypes=[], ansTypes=[]):
        """Image ids matching the given question-id / type filters."""
        quesIds, quesTypes, ansTypes = _as_list(quesIds), _as_list(quesTypes), _as_list(ansTypes)
        if not (quesIds or quesTypes or ansTypes):
            anns = self.dataset["annotations"]
        else:
            if quesIds:
                anns = [self.qa[q] for q in quesIds if q in self.qa]
            else:
                anns = self.dataset["annotations"]
            if quesTypes:
                anns = [a for a in anns if a["question_type"] in quesTypes]
            if ansTypes:
                anns = [a for a in anns if a["answer_type"] in ansTypes]
        return [a["image_id"] for a in anns]

    def loadQA(self, ids=[]):
        """Annotations for the given question id(s)."""
        if isinstance(ids, int):
            return [self.qa[ids]]
        return [self.qa[i] for i in ids]

    def showQA(self, anns) -> None:
        if not anns:
            return
        for ann in anns:
            print(f"Question: {self.qqa[ann['question_id']]['question']}")
            for ans in ann["answers"]:
                print(f"Answer {ans['answer_id']}: {ans['answer']}")

    def loadRes(self, resFile: str, quesFile: str) -> "VQA":
        """Load a results file in the official eval format, returning a new index."""
        res = VQA()
        with open(quesFile, "r") as f:
            res.questions = json.load(f)
        for key in ("info", "task_type", "data_type", "data_subtype", "license"):
            res.dataset[key] = copy.deepcopy(self.questions[key])

        print("Loading and preparing results...")
        t0 = time.time()
        with open(resFile, "r") as f:
            anns = json.load(f)
        if not isinstance(anns, list):
            raise ValueError("results is not an array of objects")
        if set(a["question_id"] for a in anns) != set(self.getQuesIds()):
            raise ValueError(
                "Results do not match this VQA set: the result file must contain a "
                "prediction for every question id in the annotation file and no "
                "question ids outside it.")
        for ann in anns:
            qid = ann["question_id"]
            if (res.dataset["task_type"] == "Multiple Choice"
                    and ann["answer"] not in self.qqa[qid]["multiple_choices"]):
                raise ValueError("predicted answer is not one of the multiple choices")
            src = self.qa[qid]
            ann["image_id"] = src["image_id"]
            ann["question_type"] = src["question_type"]
            ann["answer_type"] = src["answer_type"]
        print(f"DONE (t={time.time() - t0:0.2f}s)")

        res.dataset["annotations"] = anns
        res.createIndex()
        return res
