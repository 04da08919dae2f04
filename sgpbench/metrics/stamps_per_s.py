"""Stamps restored in the window over the window's seconds (host clock):
every call that started inside it, to the end of the last one."""


def read(rec):
    if 'stamps_done' not in rec or not rec['window_s']:
        return None
    return rec['stamps_done'] / rec['window_s']
