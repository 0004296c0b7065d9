"""HVL008 clean: every driver-originated mutation claims the epoch."""
from horovod_tpu_torch.common import kv_keys
from horovod_tpu_torch.runner.http_kv import KVServer


class Driver:
    def __init__(self):
        self.kv = KVServer(port=0)
        self.epoch = self.kv.epoch

    def push(self, gen):
        self.kv.put_json(kv_keys.notify(), {"generation": gen},
                         epoch=self.epoch)

    def gc(self, gen):
        self.kv.delete_prefix(kv_keys.rank_and_size_prefix(gen),
                              epoch=self.epoch)
        self.kv.delete(kv_keys.go(gen), epoch=self.epoch)

    def stop_serving(self):
        # a family the registry declares epoch-less claims all the same
        self.kv.put_json(kv_keys.serve_stop(), {"ts": 0.0},
                         epoch=self.epoch)

    def read(self, gen):
        # reads never claim (get_json is not a mutation)
        return self.kv.get_json(kv_keys.go(gen))
