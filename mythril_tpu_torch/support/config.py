"""On-disk configuration tier (reference mythril/mythril/mythril_config.py:16).

Bootstraps the port's data directory (`~/.mythril_tpu_torch`, override
with MYTHRIL_GPU_DIR: the JAX package's MYTHRIL_DIR never steers it) and
its `config.ini`, and resolves the RPC endpoint from, in priority order:
CLI --rpc flag > INFURA_ID env > config.ini `dynamic_loading`."""

import codecs
import logging
import os
from configparser import ConfigParser
from typing import Optional

from mythril_tpu_torch.support.lock import LockFile

log = logging.getLogger(__name__)


class MythrilConfig:
    def __init__(self):
        self.infura_id: Optional[str] = os.getenv("INFURA_ID")
        self.mythril_dir = self.init_mythril_dir()
        self.config_path = os.path.join(self.mythril_dir, "config.ini")
        self._init_config()
        self.eth = None

    @staticmethod
    def init_mythril_dir() -> str:
        mythril_dir = os.environ.get(
            "MYTHRIL_GPU_DIR",
            os.path.join(os.path.expanduser("~"), ".mythril_tpu_torch"),
        )
        if not os.path.exists(mythril_dir):
            log.info("creating mythril data directory %s", mythril_dir)
            os.makedirs(mythril_dir, exist_ok=True)
        return mythril_dir

    def _init_config(self) -> None:
        """Create config.ini with defaults on first run; read it after."""
        if not os.path.exists(self.config_path):
            log.info("no config file found, creating %s", self.config_path)
            open(self.config_path, "a").close()
        config = ConfigParser(allow_no_value=True)
        config.optionxform = str
        with LockFile(self.config_path + ".lock"):
            config.read(self.config_path, encoding="utf-8")
            changed = False
            if "defaults" not in config.sections():
                config.add_section("defaults")
                changed = True
            if not config.has_option("defaults", "dynamic_loading"):
                config.set(
                    "defaults",
                    "#- dynamic_loading: infura | HOST:PORT | off",
                    "",
                )
                config.set("defaults", "dynamic_loading", "infura")
                changed = True
            if not config.has_option("defaults", "infura_id"):
                config.set("defaults", "infura_id", "")
                changed = True
            if changed:
                with codecs.open(self.config_path, "w", "utf-8") as handle:
                    config.write(handle)
        if not self.infura_id:
            self.infura_id = config.get("defaults", "infura_id", fallback="")
        self.dynamic_loading = config.get(
            "defaults", "dynamic_loading", fallback="infura"
        )

    def set_api_rpc(self, rpc: Optional[str] = None, rpctls: bool = False):
        """Build the JSON-RPC client per the resolved endpoint."""
        from mythril_tpu_torch.ethereum.interface.client import EthJsonRpc

        endpoint = rpc or self.dynamic_loading
        if endpoint in (None, "", "off"):
            self.eth = None
            return None
        self.eth = EthJsonRpc.from_cli(
            None if endpoint == "infura" else endpoint, rpctls
        )
        return self.eth
