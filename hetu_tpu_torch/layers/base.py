"""Layer base (twin of ``hetu_tpu/layers/base.py``)."""


class BaseLayer:
    def __call__(self, *args, **kwargs):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"
