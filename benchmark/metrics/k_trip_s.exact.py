"""k_trip_s.exact: seconds a call of the exact engine spends on the
kernel's round trip through the host: K back to the host as f64
(``k_to_host``, inside ``mmt``; it also waits for the products still
queued on the card), normalised there (``k_norm``) and sent to the card
again as f32 for its eigendecomposition (``k_upload``, inside ``eigh``;
none where the host decomposes K), mean over the window's calls."""

import spans

TRIP = ("k_to_host", "k_norm", "k_upload")


def _trip(root):
    parts = spans.named(root, TRIP)
    return sum(s.wall for s in parts) if parts else None


def read(run):
    return spans.per_call(run, _trip, kind="exact")
