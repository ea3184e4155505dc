"""Typed parameter registry (Defaults.pm equivalent).

The port's own copy of canu_tpu.config.registry: every key, default,
type, synopsis, meta key, profile and check of the reference registry,
so a configuration means the same in both packages.  Synopses that name
jax or the TPU describe the reference's mechanism for that key; the port
reads the same keys.

Mirrors the reference's flag system semantics
(Canu src/pipelines/canu/Defaults.pm):

  * lowercase-normalized key lookup with registered synopses
    (Defaults.pm:93 setGlobal / :727 setDefaults);
  * tag specialization: setting `ovlMerSize` fans out to
    {cor,obt,utg}OvlMerSize unless the specialized key was set explicitly
    (Defaults.pm:109-164);
  * meta parameters: `rawErrorRate` / `correctedErrorRate` set whole
    groups (Defaults.pm:168-181);
  * unknown keys are hard errors (Defaults.pm:192);
  * sources in priority order: built-in defaults -> spec files (-s) ->
    key=value CLI (Defaults.pm:526-633);
  * `print_options()` dumps the registry (-options, Defaults.pm:327-348);
  * sizes accept units: 4.6m, 12k, 1.2g (Configure.pm:460-512).

TPU-specific parameters (band widths, hash counts) follow the same
naming conventions; the reference's per-stage memory/thread knobs are
accepted but advisory (resource solving is XLA's job here).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class ConfigError(ValueError):
    pass


_TAGS = ("cor", "obt", "utg")


def parse_size(v: str | int | float) -> float:
    """'4.6m' -> 4.6e6 etc. (k/m/g/t suffixes, case-insensitive)."""
    if isinstance(v, (int, float)):
        return float(v)
    m = re.fullmatch(r"\s*([\d.]+)\s*([kmgtKMGT]?)\s*", str(v))
    if not m:
        raise ConfigError(f"cannot parse size {v!r}")
    mult = {"": 1, "k": 1e3, "m": 1e6, "g": 1e9, "t": 1e12}[m.group(2).lower()]
    return float(m.group(1)) * mult


@dataclass
class Param:
    key: str
    default: Any
    type: Callable[[Any], Any]
    synopsis: str
    tag_base: Optional[str] = None  # for corX/obtX/utgX: the base name X


def _bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


class Config:
    def __init__(self) -> None:
        self.registry: dict[str, Param] = {}  # lowercase key -> Param
        self.values: dict[str, Any] = {}
        self.explicit: set[str] = set()
        # keys assigned via meta/tag fan-out: user-touched (a profile
        # must not overwrite them) but not pinned (a later fan-out can)
        self.fanned: set[str] = set()
        self._register_all()

    # ---- registration ----

    def _reg(self, key: str, default: Any, typ: Callable, synopsis: str) -> None:
        self.registry[key.lower()] = Param(key, default, typ, synopsis)
        self.values[key.lower()] = default

    def _reg_tagged(self, base: str, defaults: dict[str, Any], typ: Callable, synopsis: str) -> None:
        """Register corBase/obtBase/utgBase with per-tag defaults."""
        for tag in _TAGS:
            key = tag + base[0].upper() + base[1:]
            p = Param(key, defaults[tag], typ, f"[{tag}] {synopsis}", tag_base=base.lower())
            self.registry[key.lower()] = p
            self.values[key.lower()] = defaults[tag]

    def _reg_exec(self, stage: str, name: str) -> None:
        """Per-stage execution resource group (reference setExecDefaults,
        Defaults.pm:637-655): Memory/Threads/Concurrency/StageSpace +
        gridOptions<stage>.  Advisory on TPU — XLA owns device resource
        solving and there is one accelerator process per host — but
        accepted, validated, and echoed into the spec log exactly like
        the reference's.  Keys already registered with a REAL mechanism
        (e.g. batMemory -> the graph-phase overlap cap) are left
        untouched."""
        for key, syn in (
            (f"{stage}Memory",
             f"advisory GB for {name} jobs (reference {stage}Memory; "
             "resource solving is XLA's job here)"),
            (f"{stage}Threads",
             f"advisory threads for {name} jobs (reference "
             f"{stage}Threads)"),
            (f"{stage}Concurrency",
             f"advisory concurrent {name} jobs (reference notes: "
             "unused, one process)"),
            (f"{stage}StageSpace",
             f"advisory node-local staging GB for {name} jobs"),
        ):
            if key.lower() not in self.registry:
                self._reg(key, 0, int, syn)
        if f"gridoptions{stage}".lower() not in self.registry:
            self._reg(f"gridOptions{stage}", "", str,
                      f"extra launcher options for {name} jobs (applied "
                      "to the jax.distributed launch command)")

    def _register_all(self) -> None:
        self._reg("genomeSize", None, parse_size, "expected genome size (required; accepts k/m/g)")
        self._reg("minReadLength", 1000, int, "discard input reads shorter than this")
        self._reg("minOverlapLength", 500, int, "ignore overlaps shorter than this")
        self._reg("rawErrorRate", 0.30, float, "max expected error in raw-read alignments (meta: sets corOvlErrorRate)")
        self._reg("correctedErrorRate", 0.12, float, "max expected error in corrected-read alignments (meta: sets obt/utgOvlErrorRate)")
        self._reg("readType", "pacbio", str, "read technology: pacbio | nanopore")
        self._reg("stopAfter", "", str, "stop the pipeline after this stage")
        self._reg("stopBefore", "", str, "stop the pipeline just before this stage (Defaults.pm stopBefore)")
        self._reg("canuIterationMax", 2, int, "max attempts per stage before giving up")

        self._reg_tagged("ovlErrorRate", {"cor": 0.30, "obt": 0.12, "utg": 0.12}, float,
                         "overlap erate gate for this phase")
        # reference: MHAP correction at k=16, overlapInCore obt/utg at
        # k=22 (Defaults.pm ovlMerSize=22, mhapMerSize=16) — k=22 runs
        # on the exact 2-lane packing (ops.kmer extract_kmers2)
        self._reg_tagged("merSize", {"cor": 16, "obt": 22, "utg": 22}, int,
                         "k-mer size (device kernels support <= 32)")
        self._reg_tagged("mhapSensitivity", {"cor": "auto", "obt": "normal", "utg": "normal"}, str,
                         "sketch sensitivity preset: low|normal|high|auto")
        self._reg_tagged("bandWidth", {"cor": 256, "obt": 128, "utg": 128}, int,
                         "banded-extension band width (multiple of 128)")
        # verify band measured SEPARATELY from the vote-engine band: the
        # anchor-chain band centering absorbs raw-read indel drift, so
        # the overlap VERIFY needs only 128 even at 10% error — measured
        # bit-identical pair set + erates vs 256 and 7.65x faster
        # (scripts/band_experiment.py, r5); corBandWidth stays 256 for
        # the correction vote engine's window DP.
        self._reg_tagged("ovlBandWidth", {"cor": 128, "obt": 128, "utg": 128}, int,
                         "overlap-verify band width (multiple of 128; "
                         "vote engines use the wider {tag}BandWidth)")
        self._reg_tagged("merDistinct", {"cor": 0.9995, "obt": 0.9995, "utg": 0.9995}, float,
                         "fraction of distinct k-mers below the frequent-mer cutoff")
        self._reg_tagged("merThreshold", {"cor": "auto", "obt": "auto", "utg": "auto"}, str,
                         "frequent-mer cutoff: auto (mhap total-fraction), estimate (valley/peak), distinct, or a count")
        self._reg("mhapFilterThreshold", 5e-6, float,
                  "auto frequent-mer rule: ignore mers with count >= this fraction of total mers (Meryl.pm mhap ignore)")
        self._reg_tagged("minShared", {"cor": 4, "obt": 4, "utg": 4}, int,
                         "min inlier shared k-mers to keep a candidate")

        self._reg("cnsPolish", True, _bool, "plurality-polish contig consensus with tig reads")
        self._reg("cnsMinCoverage", 2, int, "min read coverage for a polished consensus call")
        self._reg("cnsPolishRounds", 3, int, "max consensus repileup rounds (abAbacus mergeRefine role)")
        self._reg("cnsMaxCoverage", 40, int, "cap read depth used for consensus (stashContains role)")
        self._reg("cnsConsensus", "plurality", str,
                  "consensus algorithm: plurality | dag | quick "
                  "(reference utgcns -pbdagcon/-utgcns/-quick)")
        self._reg("corOutCoverage", 40, int, "target coverage of corrected reads to output")
        self._reg("corMaxEvidenceCoverage", 40, int, "cap on evidence reads per corrected read")
        self._reg("corConsensus", "falcon", str,
                  "correction consensus: falcon (vote-pile plurality) | "
                  "dag (tag-chain, reference corConsensus role)")
        self._reg("corMinCoverage", 4, int,
                  "min evidence coverage for a corrected base (falconsense "
                  "min_cov; pieces split below it)")
        self._reg("corMaxEvidenceErate", 0.0, float,
                  "drop correction evidence overlaps above this error rate "
                  "(0 = off; reference corMaxEvidenceErate)")
        self._reg("saveMerCounts", False, _bool,
                  "persist each phase's full k-mer count table "
                  "(reference saveMerCounts)")
        self._reg("saveReadCorrections", False, _bool,
                  "keep per-block correction artifacts after the corrected "
                  "reads are dumped (reference saveReadCorrections)")
        self._reg("showNext", False, _bool,
                  "print the next stage that would run, then stop "
                  "(reference showNext)")
        self._reg("ovsMethod", "auto", str,
                  "overlap store build: auto | memory (in-RAM) | spill "
                  "(stream + native external sort; reference ovsMethod "
                  "sequential/parallel role)")
        self._reg("ovsShardExchange", "range", str,
                  "multi-process store-input exchange: range (a_id-range "
                  "all_to_all, no process holds the full table — reference "
                  "ovStoreBucketizer/Sorter shuffle) | allgather "
                  "(replicate the verified table on every process)")
        self._reg("batMemory", 0, int,
                  "GB budget for overlaps loaded into the graph phase; 0 = "
                  "unlimited (reference batMemory / OverlapCache limit)")
        self._reg("oeaBatchSize", 512, int,
                  "overlaps re-verified per device chunk in OEA "
                  "(reference oeaBatchSize role)")
        self._reg("logFileFlags", "", str,
                  "comma list of graph-phase log files to write "
                  "(bestedges,tigs,repeats; reference bogart "
                  "logFileFlags, AS_BAT_Logging.H)")
        self._reg("corMinEvidenceLength", 0, int, "min evidence overlap length for correction")
        # reference names and defaults (Defaults.pm:881-882, both 1).
        # Round 2 used coverage 2 (single-overlap tails cost ~0.05%
        # identity), but the r3 differential against reference canu
        # showed coverage 2 + sparse overlaps dropping half the read set;
        # iterative polish absorbs the tail cost, so match the reference.
        self._reg("trimReadsCoverage", 1, int, "min depth of overlap evidence to retain bases in trimming (reference trimReads -oc default, OverlapBasedTrimming.pm:57)")
        self._reg("trimReadsOverlap", 1, int, "min overlap between evidence to make a contiguous trim")
        self._reg("qvTrim", True, _bool, "QV clear ranges at gatekeeper for FASTQ inputs (trimReads-quality role)")
        self._reg("qvTrimMinQuality", 7.0, float, "QV trim: min windowed mean phred quality")
        self._reg("qvTrimWindow", 100, int, "QV trim: sliding window length (bases)")
        self._reg("qvEvidenceWeight", True, _bool, "weight correction votes by evidence read mean QV (tie-break)")
        self._reg("contigFilterMinReads", 2, int, "tigs with fewer reads are unassembled")
        self._reg("contigFilterMinLength", 0, int, "tigs shorter than this are unassembled")
        self._reg("contigFilterSingleReadSpan", 1.0, float,
                  "a <=2-read tig whose longest read spans this fraction of it is unassembled (reference contigFilter member 3)")
        self._reg("contigFilterLowCovFraction", 0.5, float,
                  "tigs with more than this fraction of bases below lowCovDepth are unassembled")
        self._reg("contigFilterLowCovDepth", 5, int, "depth used by contigFilterLowCovFraction")
        self._reg("stopOnReadQuality", True, _bool,
                  "abort gatekeeper when most input reads are discarded (Gatekeeper.pm stopOnReadQuality)")
        self._reg("saveOverlaps", True, _bool,
                  "keep per-phase overlap stores after the phase completes (false deletes cor/obt stores)")
        self._reg("mhapBlockSize", 256, int, "reads per sketch block (OverlapMhap.pm blockSize role)")
        self._reg("mhapMatchEngine", "auto", str,
                  "candidate matching: device (block x block compare) | "
                  "join (LSH hash-join, O(N*H) — identical pair set) | "
                  "auto (join above 5k reads; the block matrix is "
                  "quadratic in read count and cost 122-163 s/phase at "
                  "33k reads vs seconds for the join)")
        self._reg("objectStore", "", str,
                  "stash/fetch phase outputs: '' (off), TEST:<dir>, or gs://bucket (Grid_Cloud.pm)")
        self._reg("enableOEA", True, _bool, "overlap error adjustment: RED read-error voting + OEA erate recompute")
        self._reg("oeaMinAltVotes", 4, int, "RED: min evidence votes for an alternative base to call an error")
        self._reg("oeaMaxOwnVotes", 1, int, "RED: max evidence votes for the read's own base at an error")
        self._reg("oeaOnlyChanged", True, _bool,
                  "OEA: re-verify only overlaps touching a RED-corrected "
                  "read; untouched overlaps keep their stored erate "
                  "(correctOverlaps.C Correct_Frags -> Redo_Olaps on "
                  "affected frags)")
        self._reg("repeatDetect", True, _bool, "break contigs at confused repeat boundaries (bogart markRepeatReads)")
        self._reg("repeatMinEvidence", 2, int, "min distinct external reads to call a repeat region")
        self._reg("repeatConfusedAbsolute", 2100, int, "bogart -ca: external edge within this score of internal -> confused")
        self._reg("repeatConfusedPercent", 200.0, float, "bogart -cp: external edge within this percent of internal -> confused")
        self._reg("utgGraphDeviation", 6.0, float, "best edges above median + this*MAD erate are filtered (bogart deviation filter)")
        self._reg("ovlSpillPairs", 20_000_000, int,
                  "candidate-pair count above which verified overlaps stream to disk (native external sort)")
        self._reg("maxMemory", 0, int, "advisory memory cap (GB); 0 = unlimited")
        self._reg("maxThreads", 0, int, "advisory host thread cap; 0 = auto")
        self._reg("useGrid", False, _bool, "launch via jax.distributed on SLURM/TPU-pod (parallel.launch)")
        self._reg("shardedCompute", "auto", str, "run meryl/overlap-candidate stages on the device mesh: auto (on when >1 device), true, false")
        self._reg("onSuccess", "", str, "command to run when the pipeline finishes (gets the prefix as arg)")
        self._reg("onFailure", "", str, "command to run when the pipeline fails (gets the prefix as arg)")

        # ---- round-5 surface growth (Defaults.pm:727-947 parity) ----
        # phase-level erate aliases (reference corErrorRate/obtErrorRate/
        # utgErrorRate): one-member meta keys over the OvlErrorRate family
        self._reg("corErrorRate", 0.30, float,
                  "alias of corOvlErrorRate (reference corErrorRate)")
        self._reg("obtErrorRate", 0.12, float,
                  "alias of obtOvlErrorRate (reference obtErrorRate)")
        self._reg("utgErrorRate", 0.12, float,
                  "alias of utgOvlErrorRate (reference utgErrorRate)")
        self._reg("cnsErrorRate", 0.12, float,
                  "advisory max error in consensus alignments (reference "
                  "cnsErrorRate; our polish gate derives from "
                  "utgOvlErrorRate)")
        self._reg("utgRepeatConfusedBP", 2100, int,
                  "alias of repeatConfusedAbsolute (bogart -ca; reference "
                  "utgRepeatConfusedBP)")
        self._reg("utgRepeatDeviation", 6.0, float,
                  "advisory repeat-marking erate deviation (reference "
                  "utgRepeatDeviation; repeat confusion here uses "
                  "score margins, repeatConfusedAbsolute/Percent)")
        self._reg("unitigger", "bogart", str,
                  "unitig algorithm; only 'bogart' (the mutual-best graph "
                  "walk) exists, matching the reference's only value")
        self._reg("contigFilter", "2 0 1.0 0.5 5", str,
                  "five values: minReads minLength singleReadSpan "
                  "lowCovFraction lowCovDepth — meta key setting the five "
                  "contigFilter* members (reference contigFilter)")
        self._reg("batOptions", "", str,
                  "extra graph-phase options as key=value pairs (reference "
                  "batOptions free-form bogart flags)")
        self._reg("corFilter", "quick", str,
                  "template selection: quick (raw length) | expensive "
                  "(evidence-covered corrected-length estimate, reference "
                  "corFilter default 'expensive'; ours defaults quick — "
                  "identical ranking on uniform-coverage input)")
        self._reg("corPartitions", 0, int,
                  "advisory correction partition count (reference "
                  "corPartitions; device blocks are sized by the HBM vote "
                  "budget, pipeline/configure.py)")
        self._reg("corPartitionMin", 0, int,
                  "advisory min reads per correction partition")
        self._reg("cnsPartitions", 0, int,
                  "advisory consensus partition count (reference "
                  "cnsPartitions; consensus blocks by G segments)")
        self._reg("cnsPartitionMin", 0, int,
                  "advisory min reads per consensus partition")
        self._reg("corMaxEvidenceCoverageGlobal", "1.0x", str,
                  "advisory global per-evidence-read usage budget "
                  "(reference filterCorrectionOverlaps; our evidence "
                  "selection budgets per template, the Local axis)")
        self._reg("corMaxEvidenceCoverageLocal", "2.0x", str,
                  "per-read evidence budget as a multiple of estimated "
                  "coverage ('2.0x') or absolute; caps "
                  "corMaxEvidenceCoverage (generateCorrectionLayouts role)")
        self._reg("redBatchSize", 0, int,
                  "advisory reads per RED batch (reference redBatchSize; "
                  "the vote engine sizes device chunks by HBM budget)")
        self._reg("redBatchLength", 0, int,
                  "advisory bases per RED batch (reference redBatchLength)")
        self._reg("oeaBatchLength", 0, int,
                  "advisory bases per OEA batch (reference oeaBatchLength; "
                  "oeaBatchSize drives the real chunking)")
        self._reg("merylMemory", 0, int,
                  "GB for k-mer counting: scales the device counter's "
                  "HBM instance budget before the host fallback engages "
                  "(ops/kmer.py count_readset_device)")
        self._reg("merylThreads", 0, int,
                  "advisory threads for k-mer counting (reference "
                  "merylThreads)")
        self._reg("merylConcurrency", 0, int,
                  "advisory concurrent meryl jobs (reference notes: "
                  "unused, one process)")
        self._reg_tagged("ovlFrequentMers", {"cor": "", "obt": "", "utg": ""},
                         str,
                         "FASTA file of k-mers to always exclude from "
                         "seeding (reference OvlFrequentMers; unioned into "
                         "the frequent-mer set)")
        self._reg_tagged("mhapOrderedMerSize", {"cor": 12, "obt": 18,
                                                "utg": 18}, int,
                         "advisory second-stage filter k (reference "
                         "MhapOrderedMerSize; our second stage is the "
                         "banded verification itself)")
        self._reg_tagged("reAlign", {"cor": True, "obt": True, "utg": True},
                         _bool,
                         "recompute true alignments for candidate overlaps "
                         "(reference ${tag}ReAlign; always the verify "
                         "kernel's job here — false is rejected)")
        self._reg_tagged("overlapper", {"cor": "mhap", "obt": "mhap",
                                        "utg": "mhap"}, str,
                         "overlap algorithm: mhap (device sketch+verify) | "
                         "minimap (external minimap2 + PAF import; "
                         "reference ${tag}Overlapper)")
        self._reg("minimap2Path", "minimap2", str,
                  "external minimap2 binary for overlapper=minimap "
                  "(reference utilizes minimap via OverlapMMap.pm)")
        self._reg_tagged("mMapMerSize", {"cor": 15, "obt": 21, "utg": 21},
                         int,
                         "minimap k-mer size for overlapper=minimap "
                         "(reference MMapMerSize)")
        self._reg_tagged("mMapBlockSize", {"cor": 6000, "obt": 6000,
                                           "utg": 6000}, int,
                         "advisory minimap block size (reference "
                         "MMapBlockSize)")
        self._reg("minMemory", 0, int, "advisory lower memory bound (GB)")
        self._reg("minThreads", 0, int, "advisory lower thread bound")
        self._reg("stageDirectory", "", str,
                  "node-local staging dir for heavily-read stores "
                  "(reference stageDirectory; advisory — stores are "
                  "memory-mapped here)")
        self._reg("preExec", "", str,
                  "shell command sourced before each stage (reference "
                  "preExec role; recorded in the audit log)")
        self._reg("java", "", str,
                  "accepted for spec compatibility; no JVM exists in this "
                  "pipeline (MHAP is a device kernel)")
        self._reg("gnuplot", "", str,
                  "accepted for spec compatibility; plots are native SVG "
                  "(pipeline/html.py)")
        self._reg("gnuplotImageFormat", "svg", str,
                  "report figure format (reference gnuplotImageFormat; "
                  "only svg is produced)")
        self._reg("pathMap", "", str,
                  "accepted for spec compatibility (reference pathMap: "
                  "per-host binary paths; meaningless here)")
        self._reg("shell", "/bin/sh", str,
                  "shell for onSuccess/onFailure hooks (reference shell)")
        self._reg("objectStoreClient", "", str,
                  "client command for objectStore access (reference "
                  "objectStoreClient; gs:// uses gsutil)")
        self._reg("objectStoreNameSpace", "", str,
                  "namespace prefix inside the object store (reference "
                  "objectStoreNameSpace)")
        self._reg("gridOptions", "", str,
                  "extra options for every jax.distributed launch "
                  "(reference gridOptions)")
        self._reg("gridOptionsExecutive", "", str,
                  "extra options for the executive launch (reference "
                  "gridOptionsExecutive)")
        self._reg("gridOptionsJobName", "", str,
                  "job-name suffix for launches (reference "
                  "gridOptionsJobName)")
        # per-stage execution resource groups (setExecDefaults,
        # Defaults.pm:822-855)
        for stage, name in (
            ("cormhap", "correction overlap"),
            ("obtmhap", "trimming overlap"),
            ("utgmhap", "unitigging overlap"),
            ("corovl", "correction overlap verify"),
            ("obtovl", "trimming overlap verify"),
            ("utgovl", "unitigging overlap verify"),
            ("ovb", "overlap store bucketize"),
            ("ovs", "overlap store sort"),
            ("red", "read error detection"),
            ("oea", "overlap error adjustment"),
            ("bat", "unitig construction"),
            ("cns", "consensus"),
            ("gfa", "graph alignment"),
        ):
            self._reg_exec(stage, name)
        # external grid engines: explicit n/a stubs (the scale path is
        # jax.distributed over TPU pods/SLURM, parallel/launch.py); any
        # non-empty value errors in validate() with the porting pointer
        for ge in ("gridEngine", "gridEngineSubmitCommand",
                   "gridEngineNameOption", "gridEngineArrayOption",
                   "gridEngineArrayName", "gridEngineArrayMaxJobs",
                   "gridEngineOutputOption", "gridEnginePropagateCommand",
                   "gridEngineThreadsOption", "gridEngineMemoryOption",
                   "gridEngineMemoryUnits", "gridEngineNameToJobIDCommand",
                   "gridEngineNameToJobIDCommandNoArray",
                   "gridEngineStageOption", "gridEngineTaskID",
                   "gridEngineArraySubmitID", "gridEngineJobID"):
            self._reg(ge, "", str,
                      "n/a stub: external grid engines (SGE/Slurm/PBS/LSF "
                      "templates, reference Grid_*.pm) are replaced by "
                      "jax.distributed launch (parallel/launch.py); "
                      "setting this is an error")

    # ---- read-type profiles (canu.pl:499-517) ----

    # per-technology default groups, applied ONLY where the user did not
    # set the key explicitly (reference setGlobalIfUndef semantics)
    READ_TYPE_PROFILES = {
        "pacbio": {
            "corOvlErrorRate": 0.240,
            "obtOvlErrorRate": 0.045,
            "utgOvlErrorRate": 0.045,
            "rawErrorRate": 0.300,
            "correctedErrorRate": 0.045,
            "corMhapSensitivity": "auto",
        },
        "nanopore": {
            "corOvlErrorRate": 0.320,
            "obtOvlErrorRate": 0.144,
            "utgOvlErrorRate": 0.144,
            "rawErrorRate": 0.500,
            "correctedErrorRate": 0.144,
            "corMhapSensitivity": "high",
        },
    }

    def apply_read_type_profile(self) -> None:
        """Set the whole per-technology default group for readType
        (reference canu.pl:499-517) — every key the user set explicitly
        survives."""
        prof = self.READ_TYPE_PROFILES.get(str(self.get("readType")))
        if not prof:
            return
        touched = self.explicit | self.fanned
        for key, value in prof.items():
            lk = key.lower()
            if lk in ("rawerrorrate", "correctederrorrate"):
                # meta keys fan out to group members; respect touched
                # members inside set()
                if lk not in touched:
                    self.values[lk] = float(value)
                continue
            if lk not in touched:
                self.values[lk] = self.registry[lk].type(value)

    # ---- sensitivity presets (OverlapMhap.pm:109-132 equivalents) ----

    PRESETS = {"low": (256, 3), "normal": (512, 2), "high": (768, 2)}

    def sketch_preset(self, tag: str, coverage: Optional[float] = None) -> tuple[int, int]:
        """(n_hashes, min_matches) for a phase; 'auto' picks by coverage
        like the reference (low coverage -> more sensitive)."""
        name = self.get(tag + "MhapSensitivity")
        if name == "auto":
            name = "high" if (coverage or 0) < 30 else "normal"
        if name not in self.PRESETS:
            raise ConfigError(f"unknown sensitivity preset {name!r}")
        return self.PRESETS[name]

    # ---- get/set ----

    def _lookup(self, key: str) -> Param:
        p = self.registry.get(key.lower())
        if p is None:
            raise ConfigError(f"unknown parameter '{key}'")
        return p

    def get(self, key: str) -> Any:
        return self.values[self._lookup(key).key.lower()]

    def set(self, key: str, value: Any) -> None:
        lk = key.lower()
        # meta parameters set groups; the meta key becomes explicit and
        # the members it assigns are marked user-touched (fanned), so a
        # later read-type profile cannot overwrite them (the reference
        # marks fanned members as set, so its setGlobalIfUndef profile
        # application preserves them) — but a later fan-out CAN re-set
        # them, matching reference setGlobal semantics
        if lk == "rawerrorrate":
            v = float(value)
            self.values[lk] = v
            self.explicit.add(lk)
            if "corovlerrorrate" not in self.explicit:
                self.values["corovlerrorrate"] = v
                self.fanned.add("corovlerrorrate")
            return
        if lk == "correctederrorrate":
            v = float(value)
            self.values[lk] = v
            self.explicit.add(lk)
            for t in ("obt", "utg"):
                if f"{t}ovlerrorrate" not in self.explicit:
                    self.values[f"{t}ovlerrorrate"] = v
                    self.fanned.add(f"{t}ovlerrorrate")
            return
        # phase-erate aliases (reference corErrorRate/obtErrorRate/
        # utgErrorRate) and utgRepeatConfusedBP -> repeatConfusedAbsolute
        if lk in ("corerrorrate", "obterrorrate", "utgerrorrate"):
            v = float(value)
            self.values[lk] = v
            self.explicit.add(lk)
            member = lk[:3] + "ovlerrorrate"
            if member not in self.explicit:
                self.values[member] = v
                self.fanned.add(member)
            return
        if lk == "utgrepeatconfusedbp":
            v = int(value)
            self.values[lk] = v
            self.explicit.add(lk)
            if "repeatconfusedabsolute" not in self.explicit:
                self.values["repeatconfusedabsolute"] = v
                self.fanned.add("repeatconfusedabsolute")
            return
        if lk == "contigfilter":
            # five whitespace-separated values set the five members
            # (reference contigFilter, Defaults.pm:905)
            parts = str(value).split()
            if len(parts) != 5:
                raise ConfigError(
                    f"contigFilter needs 5 values (minReads minLength "
                    f"singleReadSpan lowCovFraction lowCovDepth), got "
                    f"{value!r}"
                )
            self.values[lk] = " ".join(parts)
            self.explicit.add(lk)
            for member, raw, typ in (
                ("contigfilterminreads", parts[0], int),
                ("contigfilterminlength", parts[1], int),
                ("contigfiltersinglereadspan", parts[2], float),
                ("contigfilterlowcovfraction", parts[3], float),
                ("contigfilterlowcovdepth", parts[4], int),
            ):
                if member not in self.explicit:
                    self.values[member] = typ(raw)
                    self.fanned.add(member)
            return
        # tag fan-out: bare base name sets all three tags
        fanned = False
        for tag in _TAGS:
            tk = (tag + key[0].upper() + key[1:]).lower() if not key.lower().startswith(tag) else None
            if tk and tk in self.registry:
                if tk not in self.explicit:
                    self.values[tk] = self.registry[tk].type(value)
                    self.fanned.add(tk)
                fanned = True
        if fanned:
            return
        p = self._lookup(key)
        self.values[p.key.lower()] = p.type(value)
        self.explicit.add(p.key.lower())

    # ---- parsing ----

    def parse_assign(self, text: str) -> None:
        if "=" not in text:
            raise ConfigError(f"expected key=value, got {text!r}")
        k, v = text.split("=", 1)
        self.set(k.strip(), v.strip())

    def parse_spec_file(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if line:
                    self.parse_assign(line)

    def validate(self) -> None:
        """checkParameters equivalent (Defaults.pm:1128)."""
        if self.get("genomeSize") is None:
            raise ConfigError("genomeSize must be set (e.g. genomeSize=4.6m)")
        for tag in _TAGS:
            k = self.get(tag + "MerSize")
            if not (2 <= k <= 32):
                raise ConfigError(f"{tag}MerSize={k} unsupported (device k <= 32)")
            bw = self.get(tag + "BandWidth")
            if bw % 128 != 0:
                raise ConfigError(f"{tag}BandWidth={bw} must be a multiple of 128")
            obw = self.get(tag + "OvlBandWidth")
            if obw % 128 != 0:
                raise ConfigError(
                    f"{tag}OvlBandWidth={obw} must be a multiple of 128")
            er = self.get(tag + "OvlErrorRate")
            if not (0 < er < 0.6):
                raise ConfigError(f"{tag}OvlErrorRate={er} out of range")
            mt = str(self.get(tag + "MerThreshold"))
            if mt not in ("auto", "estimate", "distinct") and not mt.isdigit():
                raise ConfigError(
                    f"{tag}MerThreshold={mt!r} must be auto, estimate, "
                    f"distinct, or a count"
                )
        if self.get("readType") not in ("pacbio", "nanopore"):
            raise ConfigError(f"readType={self.get('readType')!r} unknown")
        if str(self.get("unitigger")) != "bogart":
            raise ConfigError(
                f"unitigger={self.get('unitigger')!r}: only 'bogart' "
                "exists (the mutual-best graph walk, graph/best_overlap.py)"
            )
        if str(self.get("corFilter")) not in ("quick", "expensive"):
            raise ConfigError(
                f"corFilter={self.get('corFilter')!r} must be quick or "
                "expensive"
            )
        for tag in _TAGS:
            if not _bool(self.get(tag + "ReAlign")):
                raise ConfigError(
                    f"{tag}ReAlign=false unsupported: verification IS "
                    "re-alignment here (ops/align.verify_overlaps)"
                )
            ovp = str(self.get(tag + "Overlapper"))
            if ovp not in ("mhap", "minimap"):
                raise ConfigError(
                    f"{tag}Overlapper={ovp!r} must be mhap or minimap"
                )
            for cov_key in ("corMaxEvidenceCoverageGlobal",
                            "corMaxEvidenceCoverageLocal"):
                self.coverage_multiple(cov_key, 30.0)  # format check
        for lk, p in self.registry.items():
            if lk.startswith("gridengine") and str(self.values[lk]):
                raise ConfigError(
                    f"{p.key} is an n/a stub: external grid engines are "
                    "replaced by jax.distributed launch (useGrid=true + "
                    "parallel/launch.py; SLURM/TPU-pod bootstrap)"
                )

    def coverage_multiple(self, key: str, est_coverage: float) -> float:
        """Parse '1.0x' (multiple of estimated coverage) or an absolute
        number (reference corMaxEvidenceCoverageGlobal/Local format,
        CorrectReads.pm)."""
        v = str(self.get(key)).strip().lower()
        try:
            if v.endswith("x"):
                return float(v[:-1]) * est_coverage
            return float(v)
        except ValueError:
            raise ConfigError(
                f"{key}={v!r} must be a number or a 'N.Nx' coverage "
                "multiple"
            ) from None

    def print_options(self) -> str:
        lines = []
        for lk in sorted(self.registry):
            p = self.registry[lk]
            lines.append(f"{p.key:<24} <{self.values[lk]!r}> {p.synopsis}")
        return "\n".join(lines)

    def to_dict(self) -> dict[str, Any]:
        return {self.registry[lk].key: v for lk, v in self.values.items()}
