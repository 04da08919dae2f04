"""Stamps the server answered in the window over its device calls
(MicroBatchServer.batches_served): how far it coalesced requests."""


def read(rec):
    if not rec.get('batches_served'):
        return None
    return rec['stamps_served'] / rec['batches_served']
