"""HVL008 trigger: a driver-side module (owns a KVServer) mutating the
store without claiming its control epoch."""
from horovod_tpu_torch.common import kv_keys
from horovod_tpu_torch.runner.http_kv import KVServer


class Driver:
    def __init__(self):
        self.kv = KVServer(port=0)
        self.epoch = self.kv.epoch

    def push(self, gen):
        self.kv.put_json(kv_keys.notify(), {"generation": gen})  # no epoch

    def gc(self, gen):
        self.kv.delete_prefix(kv_keys.rank_and_size_prefix(gen))  # no epoch
        self.kv.delete(kv_keys.go(gen))  # missing epoch claim

    def stop_serving(self):
        self.kv.put_json(kv_keys.serve_stop(), {"ts": 0.0})  # epoch-less key
