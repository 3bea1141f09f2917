"""A ``StreamingEngine``'s stream replayed on the host, with no device.

``HostReplay`` drives an orderer and the numpy mirrors of the span and full
rungs with the engine's ladder logic (resync on re-layout, anticipation,
async dispatch → flight → commit, abort on rescale). What it computes is what
the engine's host state, ladder and rebuild log must equal.

It takes the modules it runs on: the JAX package's ``stream.incremental``,
``kernels.span_reorder`` and ``kernels.full_reorder`` in tests that hold the
port against the reference, or the port's own copies of them where JAX may
not be imported (a multi-rank worker, the card tests). This module imports
neither package.
"""
import numpy as np


class HostReplay:
    def __init__(self, modules, src, dst, nv, regions, config, span_repair, full_rebuild, flight):
        self.inc, self.srk, self.frk = modules
        self.o = self.inc.IncrementalOrderer(src, dst, nv, regions=regions, config=self.inc.StreamConfig(**config))
        self.span_repair, self.full_rebuild, self.flight_len = span_repair, full_rebuild, flight
        self.flight, self.log, self.last_drift, self.rate = None, [], 1.0, 0.0
        self.rung_counts = {"none": 0, "partial": 0, "full": 0}

    @property
    def orderer(self):
        return self.o

    def _resync(self):
        if self.flight is not None:
            self._abort("resync")
        self.o.drain_ops()
        self.o.needs_resync = False

    def _sync(self):
        if self.o.needs_resync:
            self._resync()
        else:
            self.o.drain_ops()

    def ingest(self, batch):
        counts = self.o.apply(batch)
        if self.o.needs_resync:
            self._resync()
            return counts, 0, True
        return counts, len(self.o.drain_ops()[0]), False

    def rescale(self, k):
        """Returns the re-layout's gather map and the old slots per region."""
        self._sync()
        if self.flight is not None:
            self._abort("rescale")
        spr_old = self.o.slots_per_region
        self.o.relayout(k)
        gm = self.o.drain_gather_map()
        self.o.needs_resync = False
        return gm, spr_old

    def _partial(self):
        o = self.o
        if self.span_repair == "host":
            o.partial_reorder()
            self._sync()
            return
        r0, r1 = o.span_bounds()
        u, v, valid = o.span_arrays(r0, r1)
        if int(valid.sum()) < 2:
            return
        cand = self.srk.identity_candidate(valid) if self.span_repair == "device" else o.geo_span_candidate(u, v, valid)
        if self.span_repair == "oracle":
            o.apply_span_order(r0, r1, cand, emit_ops=False)
        else:
            o.partial_reorder_mirror(region=r0, candidate=cand, emit_ops=False)

    def _full(self):
        o, frk = self.o, self.frk
        if self.full_rebuild == "host":
            o.full_rebuild()
            self._resync()
            return
        u, v, valid = o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy()
        o.begin_full_rebuild()
        nv, n_live, mode = o.num_vertices, int(valid.sum()), self.full_rebuild
        deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
        if mode != "geo" and not frk.greedy_fits_int32(n_live, o.config.k_min, o.config.k_max, int(deg.max())):
            mode = "geo"
            label = f"{self.full_rebuild}+host-fallback"
        else:
            label = self.full_rebuild
        if mode == "geo":
            chosen = frk.geo_full_candidate(u, v, valid, nv, o.config.k_min, o.config.k_max)
        else:
            cand = (frk.identity_candidate(valid) if mode == "device"
                    else frk.geo_full_candidate(u, v, valid, nv, o.config.k_min, o.config.k_max))
            ks = frk.eval_ks_full(o.config.k_min, o.config.k_max, o.regions)
            params = frk.greedy_params(n_live, o.config.k_min, o.config.k_max, int(deg.max()))
            chosen = frk.select_full_order_host(u, v, valid, nv, cand, ks, *params, frk.fallback_positions(nv))[0]
        live = np.asarray(chosen[:n_live], dtype=np.int64)
        self.flight = dict(mode=label, countdown=self.flight_len, src=u[live], dst=v[live], snapshot_edges=n_live)

    def _commit(self):
        fl, self.flight = self.flight, None
        replayed = self.o.rebuild_delta_batches
        ok = self.o.commit_full_rebuild(fl["src"], fl["dst"])
        splice_ops = 0
        if not ok:
            self._resync()
        else:
            splice_ops = len(self.o.drain_ops()[0])
        self.log.append(dict(kind="full_rebuild", mode=fl["mode"], committed=bool(ok), aborted=False,
                             snapshot_edges=fl["snapshot_edges"], replayed_batches=replayed,
                             splice_ops=splice_ops, flight_batches=self.flight_len - fl["countdown"]))

    def _abort(self, reason):
        fl, self.flight = self.flight, None
        self.o.abort_full_rebuild()
        self.log.append(dict(kind="full_rebuild", mode=fl["mode"], committed=False, aborted=True,
                             abort_reason=reason, snapshot_edges=fl["snapshot_edges"], replayed_batches=0,
                             splice_ops=0, flight_batches=self.flight_len - fl["countdown"]))

    def monitor(self):
        self._sync()
        d = self.o.drift()
        lookahead = 0.0
        if self.full_rebuild != "host" and self.flight_len > 0:
            self.rate = 0.7 * self.rate + 0.3 * max(0.0, d - self.last_drift)
            lookahead = self.flight_len * self.rate
        self.last_drift = d
        if self.flight is not None:
            self.flight["countdown"] -= 1
            if self.flight["countdown"] <= 0:
                self._commit()
                rung = "full"
            else:
                rung = "none"
        else:
            rung = self.o.maybe_escalate(partial_fn=self._partial, full_fn=self._full,
                                         full_lookahead=lookahead, partial_shadow=2.0 * lookahead)
            if self.flight is not None and self.flight["countdown"] <= 0:
                self._commit()
        self.rung_counts[rung] += 1
        return rung


def timeless(log):
    """Rebuild records without their timings (``*_s``)."""
    return [{k: x for k, x in r.items() if not k.endswith("_s")} for r in log]
