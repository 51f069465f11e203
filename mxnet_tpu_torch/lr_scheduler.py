"""Learning-rate schedulers (the PyTorch package's copy of
``mxnet_tpu/lr_scheduler.py``, which has no JAX in it): FactorScheduler,
MultiFactorScheduler and PolyScheduler keyed on ``num_update`` as the
Optimizer maintains it.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError("must override this")


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (reference lr_scheduler.py:38)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr "
                             "reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at "
                             "%0.5e, will not change in the future",
                             num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each listed step (reference lr_scheduler.py:77)."""

    def __init__(self, step, factor=1):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing "
                                 "integer list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal "
                                 "than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr "
                             "reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to ``final_lr`` over max_update steps (the
    reference's addition for its large-batch ImageNet recipes)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - num_update / self.max_update
        return self.final_lr + (self.base_lr - self.final_lr) * \
            frac ** self.power
