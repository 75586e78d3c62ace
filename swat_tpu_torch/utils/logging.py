# Copied from swat_tpu/utils/logging.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Run logging: case-named output dirs, main logger, loss.csv stream.

Output-format parity with reference utils/logger.py: same case-name scheme
(:9-23), the ``Epoch,Iter,Train_loss,Val_loss,Val_acc,Test_acc`` loss.csv
header (:35-36), args dump at start (:31-33).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import TextIO, Tuple


def get_logger(dir_path: str, file_name: str = "main",
               log_mode: str = "both") -> logging.Logger:
    logger = logging.getLogger(f"swat.{dir_path}.{file_name}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if log_mode in ("file", "both"):
        os.makedirs(dir_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(dir_path, f"{file_name}.log"),
                                 mode="w")
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    if log_mode in ("console", "both"):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger


def set_logger(cfg) -> Tuple[logging.Logger, TextIO]:
    """Returns (logger, loss_logger). loss_logger is an open CSV stream."""
    output_dir = cfg.output_dir
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(os.path.join(output_dir, "model_ckpts"), exist_ok=True)

    logger = get_logger(output_dir, "main", cfg.log_mode)
    logger.info("logging started")
    logger.info(f"case_name: {cfg.case_name}")
    for field in sorted(f.name for f in dataclasses.fields(cfg)):
        logger.info(f"{field} = {getattr(cfg, field)}")
    logger.info(f"train_split: {cfg.train_split}")
    logger.info(f"val_split: {cfg.val_split}")
    logger.info(f"test_split: {cfg.test_split}")

    loss_logger = open(os.path.join(output_dir, "loss.csv"), "w")
    loss_logger.write("Epoch,Iter,Train_loss,Val_loss,Val_acc,Test_acc\n")
    return logger, loss_logger
