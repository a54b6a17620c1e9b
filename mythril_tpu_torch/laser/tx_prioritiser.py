"""Transaction-sequence prioritizer
(reference laser/ethereum/tx_prioritiser/rf_prioritiser.py:60).

Chooses which function selectors to explore first when incremental tx
ordering is disabled (`args.incremental_txs = False`, wired in
analysis/symbolic.py). Two modes:

* model mode — a pickled sklearn classifier (same contract as the
  reference's RandomForest: features in, per-function probabilities out)
  loaded from `model_path`;
* heuristic mode (default, no model file shipped) — deterministic scoring
  of the solc-AST features from solidity/features.py: state-mutating and
  value-moving functions first.
"""

import logging
import pickle
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

_FEATURE_WEIGHTS = {
    "contains_selfdestruct": 100,
    "contains_delegatecall": 60,
    "contains_callcode": 50,
    "contains_call": 40,
    "transfers_value": 30,
    "contains_staticcall": 5,
    "payable": 20,
    "has_owner_modifier": -10,  # likely guarded: explore later
}


class RfTxPrioritiser:
    def __init__(self, contract, model_path: Optional[str] = None):
        self.contract = contract
        self.model = None
        if model_path:
            try:
                with open(model_path, "rb") as handle:
                    self.model = pickle.load(handle)
            except (OSError, pickle.PickleError) as error:
                log.warning("could not load prioritizer model: %s", error)
        self.features: Dict[str, Dict] = {}
        ast = getattr(contract, "solc_ast", None)
        if ast is not None:
            from mythril_tpu_torch.solidity.features import (
                SolidityFeatureExtractor,
            )

            self.features = SolidityFeatureExtractor(ast).extract_features()

    def _heuristic_score(self, name: str) -> int:
        features = self.features.get(name)
        if not features:
            return 0
        score = 0
        for key, weight in _FEATURE_WEIGHTS.items():
            if features.get(key):
                score += weight
        score += len(features.get("all_require_vars") or ()) * 2
        return score

    def predict_sequences(self, depth: int = 3) -> List[List[bytes]]:
        """Pinned selector list per transaction: tx i explores only the
        i-th best-ranked function (the predicted attack sequence), so the
        ranking actually prunes the search; txs beyond the ranking get the
        -1 wildcard (any selector / fallback)."""
        entries = self.contract.disassembly.function_entries
        selectors = list(entries)
        if self.model is not None and self.features:
            ranked = self._model_ranking(selectors)
        else:
            ranked = sorted(
                selectors,
                key=lambda sel: self._heuristic_score(
                    self._selector_name(sel)),
                reverse=True,
            )
        sequences: List[List[bytes]] = []
        for i in range(depth):
            if i < len(ranked):
                sequences.append([bytes.fromhex(ranked[i])])
            else:
                sequences.append([-1])
        return sequences

    def _selector_name(self, selector_hex: str) -> str:
        try:
            from mythril_tpu_torch.support.signatures import SignatureDB

            matches = SignatureDB().get("0x" + selector_hex)
            if matches:
                return matches[0].split("(")[0]
        except Exception:
            pass
        return f"_function_0x{selector_hex}"

    def _model_ranking(self, selectors: List[str]) -> List[str]:
        """sklearn predict_proba over the feature matrix, highest first."""
        try:
            names = [self._selector_name(sel) for sel in selectors]
            matrix = [
                [int(bool(self.features.get(n, {}).get(k)))
                 for k in sorted(_FEATURE_WEIGHTS)]
                for n in names
            ]
            probabilities = self.model.predict_proba(matrix)
            scored = sorted(
                zip(selectors, (max(p) for p in probabilities)),
                key=lambda pair: pair[1], reverse=True,
            )
            return [sel for sel, _ in scored]
        except Exception as error:
            log.warning("model ranking failed (%s); falling back", error)
            return selectors
