"""Loss averaging (reference utils.py:280-289; counterpart of
``inductive_recommendation_tpu/train/meters.py``)."""


class AverageMeter:
    def __init__(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
