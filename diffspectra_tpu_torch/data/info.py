"""Static QM9 facts the serving path needs (copied from
``diffspectra_tpu/data/info.py``): the atom vocabulary and the atom-count
histogram of the ``qm9_second_half`` train split."""

qm9_second_half = {
    "name": "QM9",
    "atom_encoder": {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4},
    "atom_decoder": ["H", "C", "N", "O", "F"],
    "train_n_nodes": {
        3: 1, 4: 3, 5: 3, 6: 5, 7: 7, 8: 25, 9: 62, 10: 178, 11: 412,
        12: 845, 13: 1541, 14: 2587, 15: 3865, 16: 5344, 17: 6461, 18: 6695,
        19: 6944, 20: 4794, 21: 4962, 22: 1701, 23: 2380, 24: 267, 25: 754,
        26: 17, 27: 132, 29: 15,
    },
    "max_n_nodes": 29,
}

dataset_info_dict = {"qm9_second_half": qm9_second_half}


def get_dataset_info(info_name: str):
    return dataset_info_dict[info_name]
