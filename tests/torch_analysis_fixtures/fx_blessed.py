"""Blessed contraction module for the QF101 fixture config."""
import torch


def q_matmul(x, w):
    return torch.matmul(x, w)     # blessed module: never flagged
