"""QF301 fixture: hidden-state randomness in step-reachable code."""
import random
import time

import numpy as np
import torch


@torch.compile
def bad_noise(x):
    return x + np.random.rand()   # QF301 positive: numpy.random


@torch.compile
def bad_clock(x):
    return x * time.time()        # QF301 positive: wall clock


@torch.compile
def bad_shuffle(x):
    return x + random.random()    # QF301 positive: stdlib random


@torch.compile
def bad_draw(x):
    return x + torch.randn(x.shape)   # QF301 positive: global generator


@torch.compile
def good_noise(x, gen):
    return x + torch.randn(x.shape, generator=gen)   # negative: explicit


def host_timer():
    return time.time()            # negative: not step-reachable
