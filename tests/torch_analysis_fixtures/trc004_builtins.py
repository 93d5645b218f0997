"""Fixture: a cache entry that calls a builtin (exempt in the port) and
closes over one value missing from its key (TRC004 in both analyzers)."""


class MiniEngine:
    def __init__(self):
        self._cache = {}

    def _cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def exec_fill(self, batch, capacity, scale):
        key = ("fill", batch.shape, capacity)       # scale is missing

        def make():
            def body(values):
                return [v * scale for v in values[:capacity]][:len(values)]
            return body

        return self._cached(key, make)(batch)
