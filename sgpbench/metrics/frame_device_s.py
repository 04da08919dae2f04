"""The device's busy seconds over the frames restored to the stop rule in
the window (device trace, every call of the window profiled on its own,
``profiling.DeviceClock``): the card's time a frame costs, which the host's
speed does not move."""


def read(rec):
    if not rec.get('frames_done') or rec.get('device_busy_s') is None:
        return None
    return rec['device_busy_s'] / rec['frames_done']
