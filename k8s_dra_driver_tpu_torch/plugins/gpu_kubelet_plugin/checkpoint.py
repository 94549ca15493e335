"""Versioned, checksummed prepare-state checkpoint.

Analogue of the reference's checkpoint machinery (``cmd/gpu-kubelet-plugin/
checkpoint.go:26-139``, ``checkpointv.go:69-135``, boot-id handling
``device_state.go:241-287``): claim preparation state lives in a JSON file
with
- a CRC checksum over the canonical encoding (corruption detection),
- versioned payloads (V1 legacy → V2 current) with upgrade-on-read and a V1
  shadow written alongside V2 to support downgrades,
- the node boot id embedded so a reboot invalidates all prepared state,
- atomic writes (tmp + fsync + rename) and flock-guarded read-mutate-write
  (the flock lives in DeviceState, which owns the RMW cycle),
- a unified-diff log of corrupt checkpoints for forensics
  (``logCheckpointDiff``, device_state.go:740-769).
"""

from __future__ import annotations

import difflib
import json
import logging
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, ClassVar, Optional

from k8s_dra_driver_tpu_torch.pkg import faultpoints, racelab, sanitizer, tracing
from k8s_dra_driver_tpu_torch.pkg.durability import atomic_publish, fsync_enabled
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.flock import Flock

logger = logging.getLogger(__name__)

# Claim checkpoint states (device_state.go / checkpointv.go). PrepareAborted
# carries a TTL and exists only in the ComputeDomain plugin's state machine
# (cmd/compute-domain-kubelet-plugin/device_state.go:430), but the state enum
# is shared here so both plugins use one checkpoint format.
STATE_PREPARE_STARTED = "PrepareStarted"
STATE_PREPARE_COMPLETED = "PrepareCompleted"
STATE_PREPARE_ABORTED = "PrepareAborted"


class CheckpointError(RuntimeError):
    pass


class CorruptCheckpointError(CheckpointError, PermanentError):
    """Corrupt on-disk state cannot heal between retries: permanent, so a
    prepare/unprepare against it short-circuits instead of burning the full
    45 s retry budget relogging the same diff."""


# Fault points (docs/fault-injection.md). The two write-side points
# bracket the atomic-publish protocol: a crash at either must leave the
# previous checkpoint fully intact (torn writes land only in the .tmp).
FP_CP_WRITE = faultpoints.register(
    "checkpoint.write",
    "crash/fail before any checkpoint byte reaches disk")
FP_CP_REPLACE = faultpoints.register(
    "checkpoint.replace",
    "crash/fail after the .tmp is durable but before the atomic rename")
FP_CP_READ = faultpoints.register(
    "checkpoint.read", "checkpoint read fails (I/O or corruption)",
    errors={"corrupt": CorruptCheckpointError, "oserror": OSError})


def _crc(payload: Any) -> int:
    """Checksum over the canonical (sorted, compact) JSON encoding with the
    checksum field zeroed — the checkpointmanager/checksum pattern."""
    data = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(data.encode())


@dataclass
class PreparedClaimCP:
    """One claim's checkpointed state."""

    state: str
    name: str = ""
    namespace: str = ""
    # The claim's allocation results at prepare time (what Unprepare and the
    # startup sweeper need even if the API object is gone).
    results: list[dict[str, Any]] = field(default_factory=list)
    # Serialized prepared devices (set in PrepareCompleted).
    prepared_devices: list[dict[str, Any]] = field(default_factory=list)
    # PrepareAborted bookkeeping (CD plugin): expiry unix time.
    aborted_expiry: float = 0.0
    # CD plugin: the PrepareAborted record is a drain's tombstone, not a
    # rolled-back prepare's; only a drain's may be dropped when the claim
    # is bound again to the drained devices. Set on the record only for a
    # drain, and serialized only when set: every other record keeps the
    # attributes and the encoding it had before the marker, which the JAX
    # package's records share, and a file written before it reads as "not
    # a drain".
    drained: ClassVar[bool] = False
    # CD plugin: the ComputeDomain uid this claim belongs to, recorded at
    # PrepareStarted so Unprepare of a mid-flight claim can still undo node
    # labels (prepared_devices only exists from PrepareCompleted on).
    domain_id: str = ""
    # VFIO passthrough: PCI BDF → driver to restore at unprepare. Written
    # BEFORE each vfio-pci bind, so a crash mid-prepare still knows exactly
    # what to unwind (the partial-VFIO-rollback ledger,
    # device_state.go:621-655). "" = device was already vfio-bound by an
    # admin; leave it alone.
    vfio_restore: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "checkpointState": self.state,
            "name": self.name,
            "namespace": self.namespace,
            "results": self.results,
            "preparedDevices": self.prepared_devices,
            "abortedExpiry": self.aborted_expiry,
            "domainID": self.domain_id,
            "vfioRestore": self.vfio_restore,
            **({"drained": True} if self.drained else {}),
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "PreparedClaimCP":
        pc = PreparedClaimCP(
            state=d.get("checkpointState", ""),
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
            results=list(d.get("results") or []),
            prepared_devices=list(d.get("preparedDevices") or []),
            aborted_expiry=float(d.get("abortedExpiry", 0.0)),
            domain_id=d.get("domainID", ""),
            vfio_restore=dict(d.get("vfioRestore") or {}),
        )
        if d.get("drained"):
            pc.drained = True
        return pc


@dataclass
class Checkpoint:
    """In-memory checkpoint: boot id + prepared claims by UID."""

    node_boot_id: str = ""
    prepared_claims: dict[str, PreparedClaimCP] = field(default_factory=dict)

    def __post_init__(self) -> None:
        # Race mode: the commit cache publishes ONE Checkpoint object
        # across threads under a GIL-atomic per-key contract
        # (read_cached); per-key detector cells prove nobody iterates or
        # touches a claim entry they don't own. No-op otherwise.
        self.prepared_claims = sanitizer.track_state(
            self.prepared_claims, "Checkpoint.prepared_claims")

    # -- (de)serialization ---------------------------------------------------

    def _v2_payload(self) -> dict[str, Any]:
        return {
            "checksum": 0,
            "nodeBootId": self.node_boot_id,
            "preparedClaims": {
                uid: pc.to_dict() for uid, pc in sorted(self.prepared_claims.items())
            },
        }

    def _v1_payload(self) -> dict[str, Any]:
        """Legacy shadow: claim uid → list of prepared device names. Written
        alongside V2 so an older plugin build can still read its subset
        (checkpoint.go:54-58 downgrade support)."""
        return {
            uid: [d.get("device", "") for d in pc.prepared_devices]
            for uid, pc in sorted(self.prepared_claims.items())
            if pc.state == STATE_PREPARE_COMPLETED
        }

    def marshal(self) -> str:
        v2 = self._v2_payload()
        v2["checksum"] = _crc(v2)
        doc = {"checksum": 0, "v1": self._v1_payload(), "v2": v2}
        doc["checksum"] = _crc(doc)
        return json.dumps(doc, sort_keys=True, indent=1)

    @staticmethod
    def unmarshal(text: str) -> "Checkpoint":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise CorruptCheckpointError(f"checkpoint is not JSON: {e}") from e
        if not isinstance(doc, dict):
            raise CorruptCheckpointError(
                f"checkpoint is not a JSON object "
                f"(got {type(doc).__name__})")

        if "v2" in doc and doc["v2"] is not None:
            v2 = doc["v2"]
            if not isinstance(v2, dict):
                raise CorruptCheckpointError("v2 payload is not an object")
            # Document-level checksum covers the whole file including the V1
            # shadow; verify when present (absent only in hand-rolled or
            # legacy files, whose v2 checksum still protects the live data).
            doc_want = doc.get("checksum", None)
            if doc_want is not None:
                if _crc(dict(doc, checksum=0)) != doc_want:
                    raise CorruptCheckpointError("document checksum mismatch")
            want = v2.get("checksum", 0)
            v2_zeroed = dict(v2, checksum=0)
            if _crc(v2_zeroed) != want:
                raise CorruptCheckpointError("v2 checksum mismatch")
            return Checkpoint(
                node_boot_id=v2.get("nodeBootId", ""),
                prepared_claims={
                    uid: PreparedClaimCP.from_dict(pc)
                    for uid, pc in (v2.get("preparedClaims") or {}).items()
                },
            )
        if "v1" in doc and doc["v1"] is not None:
            # V1 → V2 upgrade-on-read: device names only, state Completed.
            cp = Checkpoint()
            for uid, devices in doc["v1"].items():
                cp.prepared_claims[uid] = PreparedClaimCP(
                    state=STATE_PREPARE_COMPLETED,
                    prepared_devices=[{"device": d} for d in devices],
                )
            return cp
        return Checkpoint()


def bootstrap_checkpoint(
    manager: "CheckpointManager",
    node_boot_id: str,
    on_discard: Optional[Callable[[str, "PreparedClaimCP"], None]] = None,
) -> None:
    """Boot-id invalidation shared by both kubelet plugins
    (device_state.go:241-287): a reboot makes every prepared claim stale —
    visibility env and device nodes in dead containers don't survive it.
    Call with the node-global flock held. Rules that must not drift:

    - current boot id unreadable → do NOT fake a reboot and wipe live state;
    - checkpoint has no boot id (pre-boot-id format / V1 migration) → adopt
      the current id WITHOUT discarding (in-place upgrade is not a reboot);
    - boot id mismatch → run ``on_discard(uid, pc)`` for every prepared
      claim (CDI spec deletion, node-label unwinding, …) and reset.

    A failing discard hook PROPAGATES: the checkpoint is only reset after
    every claim's artifacts were undone — otherwise the reset would drop
    the last record of what still needs unwinding (startup fails and the
    next start retries the whole invalidation).

    Torn-file recovery (rename-only durability, pkg/durability.py): a
    power loss can publish the checkpoint's name before its data, so a
    corrupt MAIN file here falls back to the hard-linked ``.bak`` of the
    previous publish. The fallback is reboot-only by construction — if
    the backup carries the CURRENT boot id, the corruption happened in
    this same boot (bit rot, external damage), which the rename protocol
    cannot produce, and the original loud error stands rather than
    silently resuming from one-write-stale state.
    """
    if not manager.exists():
        manager.write(Checkpoint(node_boot_id=node_boot_id))
        return
    recovered = False
    try:
        cp = manager.read()
    except CorruptCheckpointError:
        cp = manager.read_backup()
        if (node_boot_id == ""
                or (cp is not None and cp.node_boot_id == node_boot_id)):
            # Same-boot corruption — or an unreadable current boot id,
            # which makes a reboot unprovable: never resume from (or
            # reset over) possibly-stale same-boot state.
            raise
        recovered = True
        if cp is None:
            logger.error(
                "checkpoint torn at bootstrap with no usable backup: "
                "resetting to empty (reboot-torn file; claim artifacts are "
                "healed by boot-id discard + the startup sweep)")
            cp = Checkpoint()
        else:
            logger.error(
                "checkpoint torn at bootstrap: recovered previous publish "
                "from backup (%d claims)", len(cp.prepared_claims))
    if node_boot_id == "":
        logger.warning("boot id unreadable; skipping reboot invalidation check")
        if recovered:
            manager.write(cp)  # re-publish a readable main file
        return
    if cp.node_boot_id == "":
        cp.node_boot_id = node_boot_id
        manager.write(cp)
    elif cp.node_boot_id != node_boot_id:
        logger.info("node rebooted (boot id %r -> %r): discarding %d prepared claims",
                    cp.node_boot_id, node_boot_id, len(cp.prepared_claims))
        for uid, pc in cp.prepared_claims.items():
            if on_discard is not None:
                on_discard(uid, pc)
        manager.write(Checkpoint(node_boot_id=node_boot_id))
    elif recovered:
        manager.write(cp)


class _Txn:
    """One queued checkpoint mutation awaiting its batch's commit."""

    __slots__ = ("fn", "done", "result", "error", "abandoned", "chan")

    def __init__(self, fn: Callable[["Checkpoint"], Any]):
        self.fn = fn
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        # Set by a caller that timed out waiting: once failure was
        # reported, the mutation must not be applied by a later batch.
        self.abandoned = False
        # HB channel identity: a never-reused serial, NOT id(self) —
        # txns are short-lived and CPython recycles addresses, so an
        # id-keyed channel would hand a fresh txn a dead txn's clock
        # (a phantom ordering that masks real races).
        self.chan = racelab.new_cell("cp-txn")


# Followers never wait longer than a whole commit can take (flock timeout
# plus the write itself); past this something is wedged and the claim's
# retry budget should see an error, not a hang.
COMMIT_WAIT_TIMEOUT = 60.0

# Cross-process flock budget for one batch commit (another plugin process
# may hold the lock during upgrade windows). A timeout fails the whole
# batch retryably — every queued transaction is woken with the error.
COMMIT_FLOCK_TIMEOUT = 10.0

# How often (seconds) the .bak hard link is rotated under rename-only
# durability. Staleness up to this period is safe: the fallback fires only
# on the reboot path, which discards every claim and sweeps artifacts.
BACKUP_ROTATE_PERIOD = 2.0


class CheckpointManager:
    """File-backed checkpoint store with atomic writes, corruption
    forensics, and a group-committing transaction API.

    :meth:`transact` is the concurrent-writer entry point: mutations from
    concurrent prepares/unprepares coalesce into one read → mutate* →
    marshal+fsync+rename batch (group commit), so N claims finishing
    together pay ONE fsync instead of N. The batch leader holds ``flock``
    (when configured) for the whole RMW, preserving the cross-process
    protocol; the ``checkpoint.write``/``checkpoint.replace`` fault
    points bracket each batch exactly as they bracketed each single
    write, so a crash at either leaves the previously published
    checkpoint fully intact (torn state lands only in the ``.tmp``).

    Mutation contract: a transact mutation must VALIDATE before it
    MUTATES — a mutation that raises is reported to its caller alone and
    excluded from the batch, which only works if it left the in-memory
    checkpoint untouched.

    :meth:`read`/:meth:`write` remain direct (no batching, no flock):
    they serve startup paths that already hold the flock
    (``bootstrap_checkpoint``, the startup sweep) and lock-free snapshot
    reads (probes), which atomic renames keep consistent.
    """

    def __init__(self, path: str, flock: Optional[Flock] = None,
                 on_batch: Optional[Callable[[int], None]] = None,
                 sync: Optional[bool] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._flock = flock
        self._on_batch = on_batch
        # Durability policy (pkg/durability.py): rename-only by default —
        # process crashes are covered by the atomic rename, power loss by
        # boot-id invalidation plus the .bak fallback below. Env-overridable.
        self._sync = fsync_enabled() if sync is None else sync
        # Guards _last_good (read/write run concurrently under transact).
        self._state_mu = sanitizer.new_lock("CheckpointManager._state_mu")
        # Commit pipeline: _pending_mu guards the queue; _commit_mu
        # serializes batch leaders. Order: _commit_mu -> _pending_mu.
        self._pending_mu = sanitizer.new_lock("CheckpointManager._pending_mu")
        self._commit_mu = sanitizer.new_lock("CheckpointManager._commit_mu")
        self._pending: list[_Txn] = []
        self._last_good: str = ""
        self._last_bak: float = 0.0
        # Commit-side parse cache: the Checkpoint object this manager last
        # published, plus the file's stat signature right after the
        # publish. The next batch reuses it when the signature still
        # matches (nobody else wrote), replacing an open+read+unmarshal
        # +checksum round with one stat. Guarded by _commit_mu (only the
        # batch leader touches it).
        self._commit_cache: Optional[Checkpoint] = None
        self._commit_sig: Optional[tuple[int, int, int]] = None

    def exists(self) -> bool:
        return self.path.exists()

    def read(self) -> Checkpoint:
        faultpoints.maybe_fail(FP_CP_READ)
        try:
            text = self.path.read_text()
        except FileNotFoundError:
            return Checkpoint()
        except UnicodeDecodeError as e:
            # A power-loss-torn file is arbitrary bytes, not guaranteed
            # UTF-8 — surface it as the corruption it is (the crashlab
            # torn-file injector found recovery dying here instead).
            raise CorruptCheckpointError(
                f"checkpoint is not valid UTF-8: {e}") from e
        try:
            cp = Checkpoint.unmarshal(text)
        except CorruptCheckpointError:
            self._log_corruption_diff(text)
            raise
        with self._state_mu:
            self._last_good = text
        return cp

    @property
    def backup_path(self) -> Path:
        return self.path.with_suffix(".bak")

    def write(self, cp: Checkpoint) -> None:
        faultpoints.maybe_fail(FP_CP_WRITE)
        text = cp.marshal()

        def rotate_backup(_tmp: str) -> None:
            # Runs in atomic_publish's torn window (tmp durable, main not
            # yet replaced). The site-specific fault point fires first so
            # `checkpoint.replace` schedules keep their historical
            # semantics: a crash here leaves the previous checkpoint
            # fully intact.
            faultpoints.maybe_fail(FP_CP_REPLACE)
            # Keep a recent publish as a hard-linked .bak (no data copy):
            # the power-loss fallback when rename-only durability tears
            # the main file (every window here is safe: no .bak + intact
            # main, or .bak == a recent publish + main = new). Rotation is
            # rate-limited: the fallback only ever fires on the reboot
            # path, where EVERY claim is discarded and the sweep heals
            # stray artifacts, so a .bak a few seconds stale recovers
            # exactly as well as the latest one — no need to pay 2
            # metadata round-trips per commit.
            now = time.monotonic()
            if self._sync or now - self._last_bak < BACKUP_ROTATE_PERIOD:
                return
            self._last_bak = now
            try:
                os.unlink(self.backup_path)
            except FileNotFoundError:
                pass
            except OSError:  # an un-unlinkable bak must not fail prepares
                logger.warning("cannot rotate %s", self.backup_path)
            try:
                os.link(self.path, self.backup_path)
            except FileNotFoundError:
                pass  # first write: nothing to back up yet
            except OSError as e:
                # A filesystem that cannot hard-link has NO power-loss
                # fallback under rename-only durability — say so instead
                # of silently running without the safety net (the
                # operator's cue to set GPU_DRA_CHECKPOINT_FSYNC=1).
                logger.warning(
                    "cannot hard-link %s -> %s (%s): no torn-checkpoint "
                    "backup will exist; consider GPU_DRA_CHECKPOINT_FSYNC=1",
                    self.path, self.backup_path, e)

        # The publish's stat signature comes back from the open-fd fstat:
        # rename changes the file's NAME, not its inode/size/mtime, so it
        # is what os.stat(self.path) will report after the replace.
        sig = atomic_publish(self.path, text,
                             tmp=self.path.with_suffix(".tmp"),
                             sync=self._sync, before_replace=rotate_backup)
        with self._state_mu:
            self._last_good = text
            # Retain the published object for the next batch's read
            # (callers must not mutate a Checkpoint after handing it to
            # write()).
            self._commit_cache = cp
            self._commit_sig = sig

    def read_cached(self) -> Checkpoint:
        """Stat-validated cached read for single-key lookups.

        Returns the manager's own last-published object when the on-disk
        signature proves it is still current, else falls back to
        :meth:`read`. The returned object is SHARED with the commit
        pipeline: concurrent batches mutate other claims' entries in it,
        so callers may only perform GIL-atomic lookups of keys they own
        (the per-claim flight lock makes a claim's own entry stable) —
        never iterate it. Iterating callers (gauges, audits, sweeps) use
        :meth:`read`/:meth:`prepared_claims`-style disk reads, which
        return a private parse."""
        with self._state_mu:
            cached, want = self._commit_cache, self._commit_sig
        if cached is not None:
            sig = self._stat_sig()
            if sig is not None and sig == want:
                faultpoints.maybe_fail(FP_CP_READ)
                return cached
        return self.read()

    def read_backup(self) -> Optional[Checkpoint]:
        """Last successfully published checkpoint before the current one,
        or None when missing/unreadable. Only bootstrap recovery reads it."""
        try:
            return Checkpoint.unmarshal(self.backup_path.read_text())
        except (OSError, CorruptCheckpointError, UnicodeDecodeError):
            # A torn backup (arbitrary bytes after a power loss) is the
            # same as no backup — bootstrap falls through to reset.
            return None

    def transact(self, mutate: Callable[[Checkpoint], Any]) -> Any:
        """Apply ``mutate`` atomically within one flock-guarded RMW batch;
        returns whatever ``mutate`` returned. Concurrent callers coalesce
        into a single read+write (group commit). A mutation that raises
        fails only its own caller; a batch-level failure (read or write,
        including an injected crash) fails every mutation in the batch.
        """
        # Child-only span: measures THIS caller's wall time through the
        # group commit (queue wait + batch commit), the "checkpoint" phase
        # of a claim trace. child_span never mints root traces, so
        # un-traced transact calls (unprepare, GC) stay unrecorded.
        with tracing.child_span("checkpoint.transact"):
            return self._transact_inner(mutate)

    def _transact_inner(self, mutate: Callable[[Checkpoint], Any]) -> Any:
        txn = _Txn(mutate)
        with self._pending_mu:
            self._pending.append(txn)
        batch_size = [0]
        try:
            with self._commit_mu:
                # A previous leader may already have committed us while we
                # waited for the leadership lock.
                if not txn.done.is_set():
                    self._commit_pending(batch_size)
        finally:
            # Batch-observation hook OUTSIDE the commit lock (DL105):
            # externally supplied code must not extend the leadership
            # critical section — every follower of the NEXT batch is
            # already queued on _commit_mu. Still fires when the batch
            # failed (the hook observes batch sizes, not outcomes).
            if batch_size[0] and self._on_batch is not None:
                try:
                    self._on_batch(batch_size[0])
                except Exception:  # noqa: BLE001 — metrics hook
                    pass
        if not txn.done.wait(timeout=COMMIT_WAIT_TIMEOUT):
            # Mark before raising: the caller is about to be told this
            # mutation FAILED, so a later batch draining the queue must
            # not apply it behind their back. (A leader already mid-apply
            # can still commit it — that residual window is absorbed by
            # the idempotent claim state machine, same as any "failed"
            # write that actually landed.)
            txn.abandoned = True
            raise CheckpointError(
                f"checkpoint group-commit timed out ({self.path})")
        racelab.hb_recv(txn.chan)
        if txn.error is not None:
            raise txn.error
        return txn.result

    def update(self, mutate: Callable[[Checkpoint], None]) -> Any:
        """One atomic read-mutate-write cycle (transact alias kept for
        callers written against the pre-group-commit API)."""
        return self.transact(mutate)

    def _commit_pending(self, batch_size: Optional[list] = None) -> None:
        """Commit everything queued so far as one batch. Caller holds
        ``_commit_mu``. ``batch_size``: out-param set to the batch length
        the moment it is known, so the caller can run the observation
        hook after releasing the lock even when the batch raises."""
        with self._pending_mu:
            batch, self._pending = self._pending, []
        if batch_size is not None:
            batch_size[0] = len(batch)
        if not batch:
            return
        release = None
        try:
            try:
                if self._flock is not None:
                    # Inside the failure-handling try: a FlockTimeout here
                    # (another process wedged on the lock) must fail and
                    # WAKE every queued transaction, not strand followers
                    # in done.wait(). Tight poll: the batch write is
                    # milliseconds, and every follower in the NEXT batch
                    # is waiting on this one.
                    release = self._flock.acquire(
                        timeout=COMMIT_FLOCK_TIMEOUT, poll_period=0.005)
                cp = self._read_for_commit()
                for txn in batch:
                    if txn.abandoned:
                        txn.error = CheckpointError(
                            "transaction abandoned after commit timeout")
                        continue
                    try:
                        txn.result = txn.fn(cp)
                    except Exception as e:  # noqa: BLE001 — per-txn failure
                        txn.error = e
                self.write(cp)
            except BaseException as e:
                # Batch-level failure — injected crash included: every
                # transaction in the batch failed with it (a real process
                # death would have taken all of their threads down too).
                # The in-memory object now carries mutations the disk never
                # saw: drop it, or the next batch would read phantom state.
                with self._state_mu:
                    self._commit_cache = None
                    self._commit_sig = None
                for txn in batch:
                    if txn.error is None:
                        txn.error = e
                raise
            finally:
                for txn in batch:
                    # HB edge: the leader executed this follower's mutate
                    # on ITS thread; everything it did (including writes
                    # into the shared commit-cache Checkpoint) must be
                    # ordered before the follower resuming past wait().
                    racelab.hb_send(txn.chan)
                    txn.done.set()
        finally:
            if release is not None:
                release()

    def _stat_sig(self) -> Optional[tuple[int, int, int]]:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return (st.st_ino, st.st_size, st.st_mtime_ns)

    def _read_for_commit(self) -> Checkpoint:
        """The batch leader's read: the cached object from our own last
        publish when the on-disk signature proves nobody else wrote (every
        publish is a rename → fresh inode), else a full :meth:`read`.
        Caller holds ``_commit_mu`` and the flock — mutating the returned
        object is the point. The injection point fires either way — a
        scheduled ``checkpoint.read`` fault must not be dodged by a warm
        cache."""
        return self.read_cached()

    def _log_corruption_diff(self, corrupt_text: str) -> None:
        """Unified diff of last-known-good vs corrupt content
        (device_state.go:740-769)."""
        if not self._last_good:
            logger.error("corrupt checkpoint %s (no prior good copy to diff)",
                         self.path)
            return
        diff = "\n".join(difflib.unified_diff(
            self._last_good.splitlines(), corrupt_text.splitlines(),
            fromfile="last-good", tofile="corrupt", lineterm=""))
        logger.error("corrupt checkpoint %s; diff vs last good:\n%s",
                     self.path, diff)
