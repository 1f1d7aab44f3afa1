"""The system under test: the port's W4A8 serving DDIM sampler, built
through its public API as `main_torch.py` builds it (FP teacher trajectory,
stage-1 calibration, the per-step fold inside `serving_ddim_sampler`), with
the traffic mix's sampler flags.  The port is imported here and nowhere
else in the harness, on first use."""
from __future__ import annotations

import time

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """Set-up stages of the port for one configuration and mix; each stage's
    host seconds (ended by a device sync) land in `seconds`."""

    def __init__(self, config: dict, traffic: dict, device):
        from attentiondm_tpu_torch.config import dict2namespace
        from attentiondm_tpu_torch.diffusion.sampling import make_timestep_seq
        from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
        from attentiondm_tpu_torch.models.unet import UNetConfig

        self.device = torch.device(device)
        ns = dict2namespace({k: config[k] for k in ("model", "data", "diffusion")})
        self.cfg = UNetConfig.from_config(ns)
        self.betas = DiffusionSchedule.from_config(ns, device=self.device).betas
        self.seq = make_timestep_seq(config["diffusion"]["num_diffusion_timesteps"], traffic["timesteps"],
                                     traffic["skip_type"])
        self.bits = (config["quant"]["w_bit"], config["quant"]["a_bit"])
        self.flags = dict(traffic.get("sampler_flags", {}))
        if "residual_dtype" in self.flags:
            self.flags["residual_dtype"] = DTYPES[self.flags["residual_dtype"]]
        self.seconds = {}

    def _timed(self, stage, fn):
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.seconds[stage] = time.perf_counter() - t0
        return out

    def teacher(self, params, x_cal):
        """The FP teacher's DDIM trajectory from the calibration images: each
        step's model input [S, N, H, W, C]."""
        from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
        from attentiondm_tpu_torch.models.unet import unet_apply

        def run():
            with torch.no_grad():
                _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params, self.cfg, xt, t), x_cal, self.seq,
                                         self.betas, keep_trajectory=True)
            return torch.cat([x_cal[None], traj[:-1]])

        return self._timed("teacher_s", run)

    def calibrate(self, params, xs_in):
        from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
        from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

        self.qunet = QuantizedUNet.create(self.cfg, *self.bits)
        with torch.no_grad():
            return self._timed("calibration_s", lambda: calibrate_ranges(
                self.qunet, params, self.qunet.init_state(len(self.seq), self.device), xs_in, self.seq))

    def sampler(self, params, qstates, **override):
        """`sample(x)` of the serving sampler (its fold made here)."""
        from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

        flags = {**self.flags, **override}
        with torch.no_grad():
            sample = self._timed("fold_s", lambda: serving_ddim_sampler(self.qunet, params, qstates, self.seq,
                                                                        self.betas, **flags))

        def call(x):
            with torch.no_grad():
                return sample(x)

        call.runtime = sample.runtime
        return call

    @staticmethod
    def ranges(qstates) -> dict:
        """{conv name: group ranges [S, G, 2]}."""
        return {name: st.group_ranges for name, st in qstates.items()}

    @staticmethod
    def fold_step(runtime, name: str, step: int, kernel_shape):
        """One layer's fold at one step as (codes [kh, kw, C, co], inv_ws
        [co], zcbias [co]), read through the port's `gather_step` (views of a
        packed fold's step buffer: read them before the next call)."""
        from attentiondm_tpu_torch.quant.int8_serving import gather_step

        kh, kw, C, co = kernel_shape
        lay = gather_step(runtime, step)[name]
        Np, K = lay.gqt.shape
        codes = lay.gqt.transpose(0, 1).reshape(kh, kw, K // (kh * kw), Np)[:, :, :C, :co]
        return codes, lay.inv_ws[:co], lay.zcbias[:co]


class Spans:
    """record_function spans around the port's per-step forward and K3, for
    the traced run only: the wrappers replace the module attributes the
    sampler looks up, and are taken out on exit."""

    TARGETS = {"serving_unet_apply": "portbench.step", "fused_attention_block": "portbench.K3"}

    def __enter__(self):
        from attentiondm_tpu_torch.quant import int8_serving

        self.mod, self.saved = int8_serving, {}
        for attr, label in self.TARGETS.items():
            fn = getattr(int8_serving, attr)
            self.saved[attr] = fn

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)

            setattr(int8_serving, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.mod, attr, fn)
        return False


class Blocks:
    """Hands each resblock's and attention block's input and output of the
    calls made inside it to `seen(step, name, h_in, h_out)`, by the same
    attribute swap as `Spans`."""

    TARGETS = ("_resblock_fused", "_attn_fused")

    def __init__(self, seen):
        self.seen, self.step = seen, None

    def __enter__(self):
        from attentiondm_tpu_torch.quant import int8_serving

        self.mod = int8_serving
        self.saved = {a: getattr(int8_serving, a) for a in ("serving_unet_apply",) + self.TARGETS}
        apply = self.saved["serving_unet_apply"]

        def step(params, cfg, qunet, runtime, qstates, x, t, step_idx, *a, **kw):
            self.step = step_idx
            return apply(params, cfg, qunet, runtime, qstates, x, t, step_idx, *a, **kw)

        int8_serving.serving_unet_apply = step
        for attr in self.TARGETS:
            def block(name, p, h_res, *a, _fn=self.saved[attr], **kw):
                out = _fn(name, p, h_res, *a, **kw)
                self.seen(self.step, name, h_res, out[0] if isinstance(out, tuple) else out)
                return out

            setattr(int8_serving, attr, block)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.mod, attr, fn)
        return False
