"""The window's seconds over the frames restored to the stop rule in it
(host clock): the time to a solution of stated accuracy, a frame."""


def read(rec):
    if not rec.get('frames_done'):
        return None
    return rec['window_s'] / rec['frames_done']
