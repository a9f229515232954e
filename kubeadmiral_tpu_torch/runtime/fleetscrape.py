"""Fleet aggregation: one merged telemetry pane over many processes.

A subprocess kwok farm is N member apiservers, each serving its own
/metrics and /debug surface on its own port — N uncorrelated pages.
:class:`FleetScraper` walks a roster of (instance, url, token) targets,
scrapes each member's Prometheus exposition, and merges the results —
per-instance sample counts, scrape health, and the raw series
re-labeled by instance — together with the MANAGER's own local
snapshots (breaker health, SLO status, tenant ledger) into the payload
``GET /debug/fleet`` serves (runtime/profiling.py).

The scraper is deliberately read-only and failure-tolerant: a member
that refuses its scrape becomes ``up: false`` with an error string,
never an exception on the debug route.  ``SCRAPE_S > 0``
additionally runs a background refresh thread; at 0 (the default) each
/debug/fleet GET scrapes on demand (stale results older than the
interval are refreshed either way).

See docs/observability.md § Fleet observatory.
"""

from __future__ import annotations

import http.client
import threading
import time
from typing import Callable, Optional

__all__ = [
    "FleetScraper",
    "parse_prometheus",
    "get_default",
    "set_default",
    "reset_default",
]

# Per-instance series cap in the merged payload: a 500-member farm's
# full series dump would be a multi-MB pane; the counts stay exact.
MAX_SERIES_PER_INSTANCE = 2000


# Background refresh interval in seconds (the JAX module's
# KT_FLEET_SCRAPE_S, with its default: 0 = scrape on demand only).
SCRAPE_S = 0.0


def parse_prometheus(text: str) -> dict[str, float]:
    """A minimal Prometheus text-exposition parser: ``name{labels} value``
    lines into a flat dict (comments/blank lines skipped, unparsable
    values dropped).  Enough for aggregation — no TYPE/HELP semantics."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # The value is the last whitespace-separated field; the series
        # name (labels may contain spaces inside quotes) is the rest.
        head, _, tail = line.rpartition(" ")
        if not head:
            continue
        try:
            out[head.strip()] = float(tail)
        except ValueError:
            continue
    return out


def _fetch(url: str, path: str, token: Optional[str], timeout: float) -> str:
    """GET one member route, bearer-authed; raises OSError-family on
    any transport failure (the caller folds it into scrape health)."""
    from urllib.parse import urlsplit

    split = urlsplit(url)
    conn = http.client.HTTPConnection(split.netloc, timeout=timeout)
    try:
        headers = {}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise OSError(f"HTTP {resp.status} for {path}")
        return body.decode("utf-8", errors="replace")
    finally:
        conn.close()


class FleetScraper:
    """Scrapes a roster of member /metrics pages and merges them with
    the manager's local telemetry snapshots.

    ``roster`` is a zero-arg callable returning ``[(instance, url,
    token), ...]`` — a callable, not a list, because farm membership
    changes (members join, die, get replaced) and the scrape must see
    the CURRENT roster."""

    def __init__(
        self,
        roster: Callable[[], list[tuple[str, str, Optional[str]]]],
        metrics=None,
        interval_s: Optional[float] = None,
        timeout: float = 2.0,
        manager_instance: str = "manager",
    ):
        self.roster = roster
        self.metrics = metrics
        self.interval_s = (
            float(SCRAPE_S)
            if interval_s is None else float(interval_s)
        )
        self.timeout = timeout
        self.manager_instance = manager_instance
        self._lock = threading.Lock()
        self._last: Optional[dict] = None
        self._last_at = float("-inf")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one scrape pass ---------------------------------------------------
    def scrape(self) -> dict:
        """Walk the roster once; returns (and caches) the merged doc."""
        t0 = time.perf_counter()
        instances: dict[str, dict] = {}
        errors = 0
        for instance, url, token in self.roster():
            entry: dict = {"url": url}
            try:
                text = _fetch(url, "/metrics", token, self.timeout)
                series = parse_prometheus(text)
                entry["up"] = True
                entry["samples"] = len(series)
                entry["series"] = dict(
                    list(series.items())[:MAX_SERIES_PER_INSTANCE]
                )
                if len(series) > MAX_SERIES_PER_INSTANCE:
                    entry["series_truncated"] = (
                        len(series) - MAX_SERIES_PER_INSTANCE
                    )
            except Exception as e:
                errors += 1
                entry["up"] = False
                entry["samples"] = 0
                entry["error"] = str(e)
            instances[instance] = entry
        # The manager's own registry joins the pane as one more
        # instance (same shape as a scraped member).
        if self.metrics is not None:
            series = parse_prometheus(self.metrics.render_prometheus())
            instances[self.manager_instance] = {
                "url": None,
                "up": True,
                "samples": len(series),
                "series": dict(
                    list(series.items())[:MAX_SERIES_PER_INSTANCE]
                ),
            }
        doc = {
            "scraped_at": time.time(),
            "scrape_seconds": round(time.perf_counter() - t0, 4),
            "instances": instances,
            "scrape_errors": errors,
            "manager": self._manager_snapshots(),
        }
        if self.metrics is not None:
            self.metrics.counter("fleet_scrapes_total")
            if errors:
                self.metrics.counter("fleet_scrape_errors_total", value=errors)
            self.metrics.store("fleet_instances", float(len(instances)))
        with self._lock:
            self._last = doc
            self._last_at = time.monotonic()
        return doc

    def _manager_snapshots(self) -> dict:
        """The manager-local surfaces the fleet pane merges in: breaker
        health, SLO status, tenant ledger — each best-effort (an
        uninstalled surface is absent, never an error)."""
        out: dict = {}
        try:
            from kubeadmiral_tpu_torch.transport import breaker as breaker_mod

            out["members"] = breaker_mod.members_report()
        except Exception:
            pass
        try:
            from kubeadmiral_tpu_torch.runtime import slo as slo_mod

            rec = slo_mod.get_default()
            if rec is not None and getattr(rec, "enabled", False):
                out["slo"] = rec.summary(slowest=0)
        except Exception:
            pass
        try:
            from kubeadmiral_tpu_torch.runtime import tenancy as tenancy_mod

            ledger = tenancy_mod.get_default()
            if ledger is not None:
                out["tenants"] = ledger.summary()
        except Exception:
            pass
        return out

    def summary(self, refresh: bool = True) -> dict:
        """The cached merged doc, refreshed when stale (older than the
        scrape interval, or never scraped).  ``refresh=False`` returns
        whatever is cached (possibly a placeholder)."""
        with self._lock:
            last, last_at = self._last, self._last_at
        age = time.monotonic() - last_at
        stale = last is None or age > max(self.interval_s, 0.0)
        if refresh and stale:
            try:
                return self.scrape()
            except Exception as e:
                return {"error": str(e), "instances": {}}
        return last if last is not None else {"instances": {}}

    # -- background refresh ------------------------------------------------
    def start(self) -> bool:
        """Spawn the periodic refresher (SCRAPE_S > 0 only)."""
        if self.interval_s <= 0 or self._thread is not None:
            return False
        self._stop.clear()
        t = threading.Thread(
            target=self._run, name="kt-fleetscrape", daemon=True
        )
        self._thread = t
        t.start()
        return True

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape()
            except Exception:
                pass  # a failed pass keeps the previous pane


# -- process default ----------------------------------------------------------
_default: Optional[FleetScraper] = None
_default_lock = threading.Lock()


def get_default() -> Optional[FleetScraper]:
    """The installed fleet scraper, or None (no auto-construction: a
    scraper needs a roster, so embedders install one explicitly)."""
    return _default


def set_default(scraper: Optional[FleetScraper]) -> Optional[FleetScraper]:
    global _default
    with _default_lock:
        prev = _default
        _default = scraper
    return prev


def reset_default() -> None:
    prev = set_default(None)
    if prev is not None:
        prev.stop()
