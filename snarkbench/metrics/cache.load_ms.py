"""The set-up's CacheManager.get of the zkey (load_zkey_cache: parse,
upload, plan_sort, key_table, records), ms; the phases are logged."""


def read(run):
    return run.cache_load_s * 1e3 if run.cache_phases else None
