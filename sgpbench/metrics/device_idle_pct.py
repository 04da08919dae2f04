"""Share of the profiled stretch in which no operation ran on the device:
100 * (1 - union of the device's activity intervals / the stretch's
wall)."""


def read(rec):
    prof = rec.get('profile')
    if not prof or not prof['window_s'] or not prof['busy_s']:
        return None
    return 100.0 * (1.0 - prof['busy_s'] / prof['window_s'])
