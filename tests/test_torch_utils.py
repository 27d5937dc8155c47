"""The port's utility surface (vqa_tpu_torch.utils), as tests/test_utils_aux.py
holds vqa_tpu's: the reference's public names, the flag coercers, sort_batch
and plot_data on the port's dict batches."""

import os

import numpy as np
import pytest
import torch


class TestUtilsSurface:
    def test_reference_names_importable(self):
        from vqa_tpu_torch import utils
        for name in ("preprocess_text", "pad_sequences", "build_vocab",
                     "build_answer", "save_vocab", "load_vocab",
                     "filter_samples_by_label", "plot_data", "print_and_log",
                     "str2bool", "int_min_two", "sort_batch"):
            assert callable(getattr(utils, name)) and name in utils.__all__

    def test_flag_coercers(self):
        from vqa_tpu_torch.utils import int_min_two, str2bool
        assert str2bool("True") is True and str2bool("false") is False
        with pytest.raises(ValueError):
            str2bool("yes")
        assert int_min_two("5") == 5
        with pytest.raises(ValueError):
            int_min_two(1)

    def test_sort_batch_and_filter_match_vqa_tpu(self, tmp_path):
        """The same orders and lines as vqa_tpu's, from numpy arrays and CPU
        tensors alike."""
        from vqa_tpu import utils as ref
        from vqa_tpu_torch import utils

        rng = np.random.default_rng(3)
        batch = (rng.integers(0, 255, (5, 4, 4, 3), dtype=np.uint8),
                 rng.integers(0, 9, (5, 6)), np.arange(5), np.array([2, 5, 2, 6, 1]))
        want = ref.sort_batch(*batch)
        for got in (utils.sort_batch(*batch),
                    utils.sort_batch(*(torch.from_numpy(a) for a in batch))):
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        data = tmp_path / "d.txt"
        data.write_text("a.jpg\tq,one\tyes\nb.jpg\tq,two\tno\nc.jpg\tq,three\tyes\n")
        assert utils.filter_samples_by_label(str(data), ["yes"]) == \
            ref.filter_samples_by_label(str(data), ["yes"])


class TestPlotData:
    @pytest.mark.parametrize("images", ["numpy", "cpu_tensor"])
    def test_saves_figures(self, tmp_path, images):
        from vqa_tpu_torch.utils import plot_data

        image = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
        batches = [{
            "image": image if images == "numpy" else torch.from_numpy(image),
            "question": np.array([[2, 3, 0], [4, 5, 6]], np.int32),
            "label": np.array([0, 1], np.int32),
        }] * 2
        idx2word = {0: "<PAD>", 2: "is", 3: "cat", 4: "what", 5: "dog", 6: "doing"}
        idx2label = {0: "UNKNOWN", 1: "yes"}
        figs = plot_data(iter(batches), idx2word, idx2label, num_plots=2,
                         save_dir=str(tmp_path))
        assert len(figs) == 2
        assert sorted(os.listdir(tmp_path)) == ["sample_0.png", "sample_1.png"]
