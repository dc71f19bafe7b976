"""Tables made once per key and kept: ``kept(maxsize)`` is
``functools.lru_cache(maxsize)`` that, while a fake tensor mode is active
(a FLOP count over fake tensors, tools/benchmark.forward_flops), makes the
table anew and keeps nothing, so that no fake tensor reaches a later real
call."""

import functools

from torch._guards import detect_fake_mode


def kept(maxsize):
    def wrap(make):
        cached = functools.lru_cache(maxsize=maxsize)(make)

        @functools.wraps(make)
        def table(*key):
            if detect_fake_mode() is not None:
                return make(*key)
            return cached(*key)
        return table
    return wrap
