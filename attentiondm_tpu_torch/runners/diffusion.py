"""The runner (port of `attentiondm_tpu/runners/diffusion.py`): train, test and sample.

`Diffusion(args, config, device=None)` trains a model (`train()`: the
config's optimizer, clipping and EMA over its dataset, snapshots of the
training state, `--resume_training`), evaluates one (`test()`: the eps-MSE
on the test split, float, fake-quant or served through the CUDA kernels),
and samples: it loads a model (a `.npz` param tree, or a training state's
EMA or params as the config's `model.ema` says, a torch DDIM `.ckpt` /
`.pth` converted by name, a registered checkpoint by name, or seeded random
weights), calibrates it (stage 1, the W4 weight pass, stage 2 in either
mode, the fold refinement, stage 3, the calibration cache) and samples
through one of three models: the fused int8 serving sampler (`--execution
serving`, the CUDA kernels), the fake-quant model, or the float model
(`--fp32`, at `--compute_dtype`).  `sample()` writes a grid and
`sample_<i>.png`, or with `--fid` numbered PNGs (the C++ writer,
`native.write_png_batch`, as JAX's) for a bulk run that resumes where it
stopped, or a `--sequence` / `--interpolation` grid.  With
`--fid_stats` the `--fid` folder is scored once it is written: Inception
statistics on the device against the reference `.npz` (or folder), the
Frechet distance printed as `FID: x.xxxx`.

All randomness goes through `randomness(stream, shape, index)`: a
`torch.Generator` on the device, seeded from `--seed` at JAX's offsets (+1
for the training steps, +77 for the calibration set, +99 for stage 2),
whose first draw is a batch's initial noise (the test batch's eps) and
whose later draws are its sampler's per-step noise (a training step's t,
eps and dropout masks).  A test replaces that one method to hand in JAX's
draws (`{"noise": ...}`, `{"t": ..., "e": ..., "dropout_masks": ...}` in
place of `{"generator": ...}`).  The loader's shuffle stays numpy's
`default_rng(seed + epoch)`, as in JAX.
"""
from __future__ import annotations

import dataclasses
import glob
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import default_device
from ..data.transforms import inverse_data_transform, inverse_transform_uint8
from ..diffusion.sampling import ddim_sample, ddpm_sample, make_timestep_seq
from ..diffusion.schedules import DiffusionSchedule
from ..models.unet import UNetConfig, cast_params, count_params, unet_apply, unet_init
from ..native import write_png_batch
from ..parallel import make_mesh
from ..parallel.distributed import world
from ..quant.calibrate import (
    calibrate_differentiable,
    calibrate_ranges,
    select_calibration_images,
)
from ..quant.qunet import QuantizedUNet
from ..utils.images import save_image, save_image_grid

# the offsets from --seed of JAX's keys: the training steps' PRNGKey(seed + 1), the calibration set's
# PRNGKey(seed + 77), stage 2's PRNGKey(seed + 99)
SEED_OFFSETS = {"sample": 0, "interpolation": 0, "fid": 0, "calibration": 77, "calibration t": 77, "stage2": 99,
                "train": 1, "transform": 0, "test": 0}
_STREAM_IDS = {name: i for i, name in enumerate(SEED_OFFSETS)}


def _contiguous_prefix(folder: str) -> int:
    """Length of the contiguous 0..k-1 run of `<id>.png` files in `folder`:
    the `--fid` resume point (ids past the first hole are generated again)."""
    ids = set()
    for p in glob.glob(os.path.join(folder, "*.png")):
        stem = os.path.splitext(os.path.basename(p))[0]
        if stem.isdigit():
            ids.add(int(stem))
    k = 0
    while k in ids:
        k += 1
    return k


class Diffusion:
    def __init__(self, args, config, device=None):
        self.args = args
        self.config = config
        self.device = default_device() if device is None else torch.device(device)
        self.schedule = DiffusionSchedule.from_config(config, device=self.device)
        self.betas = self.schedule.betas
        self.num_timesteps = self.schedule.num_timesteps
        ucfg = UNetConfig.from_config(config)
        if getattr(args, "attn_variant", "ddim") != "ddim":
            ucfg = dataclasses.replace(ucfg, attn_variant=args.attn_variant)
        self.ucfg = ucfg
        self.sample_count = None  # the 'diff' t-mode's bookkeeping
        self.timestep_select = None
        self.attn_ranges = None
        self.weight_extras = None
        self.timings = {}  # seconds of each stage of the last run, by name
        self.serving = None  # the serving sampler and what it was built from, after a serving sample()
        self.fid_images = 0  # images the last --fid run generated
        self.fid_score = None  # the last --fid_stats score
        self.rank, self.world = world()  # this process's rank in the default process group (0, 1 without one)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def make_seq(self):
        return make_timestep_seq(self.num_timesteps, self.args.timesteps, getattr(self.args, "skip_type", "uniform"))

    def randomness(self, stream: str, shape=None, index: int = 0):
        """(x, sampler keywords) of one random stream: a generator on the
        device seeded from --seed, the stream's offset (`SEED_OFFSETS`), the
        stream and `index` (a `--fid` batch's); x is its first draw of
        `shape` (None without one), and `{"generator": g}` goes to the
        sampler (or calibration) that draws on from it."""
        base = int(self.args.seed) + SEED_OFFSETS[stream]
        g = torch.Generator(device=self.device).manual_seed(base * 2 ** 32 + _STREAM_IDS[stream] * 2 ** 24 + index)
        x = None if shape is None else torch.randn(shape, generator=g, device=self.device)
        return x, {"generator": g}

    def _timed(self, key: str, fn):
        """fn(), its seconds (between device synchronizations) added to `timings[key]`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[key] = self.timings.get(key, 0.0) + time.perf_counter() - t0
        return out

    def _image_shape(self, n: int):
        d = self.config.data
        return (n, d.image_size, d.image_size, d.channels)

    def _pretrained_name(self):
        """Registry key for --use_pretrained, per dataset (the EMA variant where the config keeps EMA)."""
        d = self.config.data
        name = d.dataset.upper()
        if name == "CIFAR10":
            return "ema_cifar10" if self.config.model.ema else "cifar10"
        if name == "LSUN":
            cat = getattr(d, "category", "bedroom")
            key = {"church_outdoor": "lsun_church", "bedroom": "lsun_bedroom", "cat": "lsun_cat"}[cat]
            return ("ema_" + key) if self.config.model.ema else key
        raise KeyError(f"no pretrained checkpoint registered for dataset {d.dataset}")

    def _load_params(self):
        """Model params: a `.npz` checkpoint (a param tree, or a training
        state's EMA where the config's `model.ema` is set, else its params),
        a torch `.ckpt` / `.pth` converted by
        name, or seeded random init where no checkpoint is found."""
        from ..checkpoint import load_params
        from ..models.torch_convert import load_torch_checkpoint

        path = getattr(self.args, "ckpt_path", None)
        if path is None and getattr(self.args, "use_pretrained", False):
            from ..pretrained import get_ckpt_path

            path = get_ckpt_path(self._pretrained_name())
        if path is None:
            log_path = getattr(self.args, "log_path", None)
            if log_path:
                for cand in ("ckpt.npz", "ckpt.pth", "model-790000.ckpt"):
                    p = os.path.join(log_path, cand)
                    if os.path.exists(p):
                        path = p
                        break
        if path and os.path.exists(path):
            logging.info(f"loading checkpoint {path}")
            if path.endswith(".npz"):
                return load_params(path, unet_init(torch.Generator().manual_seed(0), self.ucfg, "cpu"), self.device,
                                   ema=bool(self.config.model.ema))
            if self.ucfg.model_type == "adm":  # a guided-diffusion state dict (lsun_bedroom.pt ...)
                from ..models.adm import from_guided_diffusion

                return from_guided_diffusion(torch.load(path, map_location="cpu", weights_only=True), self.ucfg,
                                             self.device)
            # CelebA-style training checkpoints carry the EMA weights in the list's tail
            ema = self.config.data.dataset.upper() == "CELEBA" and bool(self.config.model.ema)
            return load_torch_checkpoint(path, self.ucfg, ema=ema, device=self.device)
        logging.warning("no checkpoint found — using random init (smoke mode)")
        return unet_init(torch.Generator().manual_seed(int(self.args.seed)), self.ucfg, self.device)

    def _qunet(self):
        args = self.args
        return QuantizedUNet.create(self.ucfg, bitwidth=args.bitwidth, a_bitwidth=getattr(args, "a_bitwidth", None),
                                    group_num=int(getattr(args, "normgroup", 0) or 0))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _train_state_like(self):
        """The training state a checkpoint of this config loads into: the
        config's optimizer state, and an EMA where `model.ema` is set."""
        from ..training import get_optimizer, init_train_state

        params = unet_init(torch.Generator().manual_seed(0), self.ucfg, self.device)
        return init_train_state(params, get_optimizer(self.config), use_ema=bool(self.config.model.ema))

    def _train_mesh(self):
        """(mesh, data ranks, tp, sp) of `train()`, as JAX's runner picks
        them: --tp with --sp drops --sp; a degree that does not divide the
        world (or, for --tp, the 32 GroupNorm groups) falls back to pure
        data parallelism, with a warning."""
        args = self.args
        tp, sp = int(getattr(args, "tp", 1) or 1), int(getattr(args, "sp", 1) or 1)
        n_all = self.world
        if tp > 1 and sp > 1:
            logging.warning("--tp and --sp shard the same mesh axis; ignoring --sp")
            sp = 1
        if tp > 1 and (n_all % tp or 32 % tp):
            logging.warning(f"--tp {tp} must divide the device count ({n_all}) and the 32 GroupNorm groups; "
                            "falling back to pure DP")
            tp = 1
        if sp > 1 and n_all % sp:
            logging.warning(f"--sp {sp} must divide the device count ({n_all}); falling back to pure DP")
            sp = 1
        if tp > 1 or sp > 1:
            model = tp if tp > 1 else sp
            return make_mesh(axes=("data", "model"), shape=(n_all // model, model)), n_all // model, tp, sp
        mesh = make_mesh()
        return mesh, mesh.size, tp, sp

    def train(self):
        """Train on the config's dataset on this runner's device: batches of
        `training.batch_size` from `iterate_batches(seed=--seed + epoch,
        workers=data.num_workers)`, one `make_train_step` step each (the
        config's optimizer, `optim.grad_clip`, the EMA at `model.ema_rate`
        where `model.ema` is set) until `training.n_iters`; the loss of each
        step is read one step late (`.item()` waits for the device), logged
        to `<log_path>/train_metrics.csv` and `<exp>/tensorboard/<doc>`; the
        training state goes to `ckpt_<step>.npz` and `ckpt.npz` at step 1
        and every `snapshot_freq` steps.  `--resume_training` loads
        `ckpt.npz` and continues from its step, with the draws, the shuffle
        and the epoch count started again from 0, as JAX's runner does.
        The final state stays on `train_state`, each step's host seconds on
        `step_seconds` (the loop's on `timings["train"]`).

        Over several ranks (`parallel.initialize_distributed`) the step is
        `make_sharded_train_step` on the mesh `_train_mesh` picks (data
        parallel, data x tensor with --tp, data x spatial with --sp); the
        batch is cut to a multiple of the data ranks, every rank loads the
        whole batch and keeps its slice, and rank 0 writes the logs and the
        checkpoints (gathered to whole tensors under --tp; `--resume_training`
        cuts them to the shards again).  With one rank the step is
        `make_train_step` (`make_sharded_train_step` of a one-rank mesh)."""
        from ..checkpoint import load_checkpoint, save_checkpoint
        from ..data.datasets import get_dataset
        from ..data.loader import iterate_batches
        from ..data.transforms import data_transform
        from ..parallel import gather_unet_params, shard_unet_params, unet_param_specs
        from ..parallel.tp import describe_sp
        from ..training import get_optimizer, init_train_state, make_sharded_train_step, map_train_state
        from ..utils.metrics_log import MetricsLogger
        from ..utils.tb_writer import SummaryWriter

        args, config = self.args, self.config
        train_ds, _ = get_dataset(args, config)
        mesh, n_dev, tp, sp = self._train_mesh()
        n_all = mesh.size
        batch = config.training.batch_size
        batch -= batch % n_dev or 0
        logging.info(f"training on {n_all} device(s) ({self.device}; dp{n_dev} x tp{tp} x sp{sp}), batch {batch}"
                     + (f"; {describe_sp(self.ucfg, sp)}" if sp > 1 else ""))
        tx = get_optimizer(config)
        params = unet_init(torch.Generator().manual_seed(int(args.seed)), self.ucfg, self.device)
        state = init_train_state(params, tx, use_ema=bool(config.model.ema))
        start_step = 0
        ckpt_path = os.path.join(args.log_path, "ckpt.npz")
        if args.resume_training and os.path.exists(ckpt_path):
            state = load_checkpoint(ckpt_path, state, device=self.device)
            start_step = int(state.step)
            logging.info(f"resumed from step {start_step}")
        kw = dict(grad_clip=getattr(config.optim, "grad_clip", None),
                  ema_rate=config.model.ema_rate if config.model.ema else None)
        specs = None
        if tp > 1:  # the checkpoint's whole tensors, cut to this rank's shards
            specs = unet_param_specs(params)
            state = map_train_state(lambda tree: shard_unet_params(mesh, tree), state)
        step_fn = make_sharded_train_step(mesh, self.ucfg, self.betas, tx, param_specs=specs, spatial=sp > 1, **kw)
        main = self.rank == 0
        logger = MetricsLogger(os.path.join(args.log_path, "train_metrics.csv")) if main else None
        tb_logger = SummaryWriter(os.path.join(args.exp, "tensorboard", args.doc)) if main else None
        _, transform_kw = self.randomness("transform")
        self.step_seconds = []
        t_train = time.perf_counter()
        pending = None

        def flush(p):
            if p is None:
                return
            p_step, p_loss, p_dt, p_epoch = p
            p_loss = p_loss.item()
            logging.info(f"step: {p_step}, loss: {p_loss:.5f}, data time: {p_dt:.3f}")
            if main:
                logger.log(p_step, loss=p_loss, data_s=round(p_dt, 4), epoch=p_epoch)
                tb_logger.add_scalar("loss", p_loss, p_step)

        def save(step):
            """The state under JAX's keys, whole tensors (gathered over tp), written by rank 0."""
            whole = state if specs is None else map_train_state(lambda tree: gather_unet_params(mesh, tree, specs),
                                                                state)
            if main:
                save_checkpoint(os.path.join(args.log_path, f"ckpt_{step}.npz"), whole)
                save_checkpoint(ckpt_path, whole)

        step = start_step
        workers = int(getattr(config.data, "num_workers", 0) or 0)
        for epoch in range(config.training.n_epochs):
            t_data = time.time()
            for x, _y in iterate_batches(train_ds, batch, seed=args.seed + epoch, workers=workers):
                data_time = time.time() - t_data
                t0 = time.perf_counter()
                x0 = data_transform(config, torch.from_numpy(x).to(self.device), **transform_kw)
                _, draws = self.randomness("train", index=step - start_step)
                state, loss = step_fn(state, x0, **draws)
                step += 1
                flush(pending)  # the previous step's loss: this step is queued on the device meanwhile
                pending = (step, loss, data_time, epoch)
                if step % config.training.snapshot_freq == 0 or step == 1:
                    flush(pending)
                    pending = None
                    save(step)
                self.step_seconds.append(time.perf_counter() - t0)
                if step >= config.training.n_iters:
                    break
                t_data = time.time()
            if step >= config.training.n_iters:
                break
        flush(pending)
        if main:
            tb_logger.close()
        self.train_state = state
        self.timings["train"] = time.perf_counter() - t_train

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def test(self):
        """The eps-MSE (summed over pixels, averaged over images) on the
        test split, under the same execution flags as `sample()`: the float
        model with --fp32 (or bitwidth <= 0), else the fake-quant model, or
        with --execution serving the calibrated model served through the
        kernels (`serving_unet_apply`).  The quantized models take each batch
        at one sampler step, the batches walking the schedule at an even
        stride (stratified coverage); the float model draws t per image.  At
        most --num_samples images (default 11 batches of at most 64); the log
        states the coverage.  Returns the mean; the figures stay on
        `test_result`."""
        from ..data.datasets import get_dataset
        from ..data.loader import iterate_batches
        from ..data.transforms import data_transform
        from ..diffusion.losses import noise_estimation_loss

        args, config = self.args, self.config
        _, test_ds = get_dataset(args, config)
        params = self._timed("load", self._load_params)
        batch = max(1, min(getattr(config.sampling, "batch_size", 64), 64, len(test_ds)))
        ucfg = self.ucfg
        quant = not getattr(args, "fp32", False) and args.bitwidth > 0
        serving = quant and getattr(args, "execution", "fake_quant") == "serving"
        desc = "fp32"
        if quant:
            # the quantized state is indexed by sampler step: each batch is evaluated at one step of the schedule
            seq = self.make_seq()
            S = len(list(seq))
            t_rev = np.asarray(list(seq))[::-1]
            qunet = self._qunet()
            qstates = qunet.init_state(S, self.device)
            qstates, _ = self.calibrate_model(params, qunet, qstates, seq, first=True, compute_extras=serving,
                                              collect_attn_ranges=serving and bool(getattr(args, "attn_int8", False)))
            bits = f"W{args.bitwidth}A{getattr(args, 'a_bitwidth', None) or args.bitwidth}"
            if serving:
                from ..quant.int8_serving import prepare_serving_runtime, serving_unet_apply

                runtime = self._timed("fold", lambda: prepare_serving_runtime(
                    qunet, params, qstates, weight_extras=self.weight_extras,
                    rank1=bool(getattr(args, "shared_fold", False)), pack_int4=bool(getattr(args, "pack_int4", False))))

                def apply(x, t_vec, i):
                    return serving_unet_apply(params, ucfg, qunet, runtime, qstates, x, t_vec, i, attn_int8=False)

                desc = f"serving-int8 {bits}"
            else:
                qparams, _ = qunet.prepare_params(params)

                def apply(x, t_vec, i):
                    return qunet.apply(qparams, qstates, x, t_vec, i)

                desc = f"fake-quant {bits}"
            abar = torch.cumprod(1.0 - self.betas, dim=0)

            def eval_loss(x0, e, t, i):
                a = abar[int(t_rev[i])]
                x = x0 * torch.sqrt(a) + e * torch.sqrt(1.0 - a)
                t_vec = torch.full((x0.shape[0],), float(t_rev[i]), device=self.device)
                return torch.square(e - apply(x, t_vec, i)).sum(dim=(1, 2, 3)).mean()
        else:
            def eval_loss(x0, e, t, i):
                return noise_estimation_loss(lambda x, tt: unet_apply(params, ucfg, x, tt), x0, t, e, self.betas)[0]

        max_examples = args.num_samples or 11 * batch
        losses, step_losses = [], {}  # quantized: sampler step -> its batches' losses
        seen = bi = 0
        if quant:
            n_expected = max(1, -(-max_examples // batch))
            stride = S / n_expected if n_expected < S else 1.0
        t0 = time.perf_counter()
        for x, _y in iterate_batches(test_ds, batch, shuffle=False):
            x0 = data_transform(config, torch.from_numpy(x).to(self.device))
            e, draws = self.randomness("test", tuple(x0.shape), bi)
            i = int(bi * stride) % S if quant else None
            t = None
            if not quant:
                t = draws["t"] if "t" in draws else torch.randint(
                    0, self.num_timesteps, (x0.shape[0],), generator=draws["generator"], device=self.device)
            with torch.no_grad():
                loss = eval_loss(x0, e, t, i).item()
            losses.append(loss)
            if quant:
                step_losses.setdefault(i, []).append(loss)
            seen += x0.shape[0]
            bi += 1
            if seen >= max_examples:
                break
        self.timings["test"] = time.perf_counter() - t0
        avg = float(np.mean(losses))
        logging.info(f"test eps-MSE (sum over pixels, {desc}): {avg:.4f} over {seen}/{len(test_ds)} test examples "
                     f"({len(losses)} batches; --num_samples raises the cap)")
        self.test_result = dict(eps_mse=avg, desc=desc, seen=seen, total=len(test_ds), batches=len(losses),
                                batch=batch)
        if step_losses:
            per_step = {i: float(np.mean(v)) for i, v in sorted(step_losses.items())}
            worst = max(per_step, key=per_step.get)
            logging.info(f"  timestep coverage: {len(per_step)}/{S} sampler steps (stratified); worst step {worst} "
                         f"(t={int(t_rev[worst])}): {per_step[worst]:.4f}")
            self.test_result.update(steps_covered=len(per_step), steps=S, worst_step=worst)
        return avg

    def _score_fid(self):
        """Score the --fid folder (--fid_stats) as JAX's runner does: the
        generated images' Inception statistics from float32 sums of f and
        f f^T on the device (`sharded_statistics`, each batch split over the
        data ranks and the sums all-reduced), the reference statistics
        of --fid_stats (`.npz` or an image folder), and the Frechet distance
        (`frechet_smoke_safe`: eigenvalue form below 2048 images), printed
        as `FID: x.xxxx` and returned.  Canonical FID needs
        --inception_weights (the pt_inception state dict); without it a
        seeded random Inception gives numbers comparable only to statistics
        from the same network."""
        from ..eval import fid as fid_eval
        from ..eval.inception import InceptionV3FID

        args = self.args
        w = getattr(args, "inception_weights", None)
        if w:
            net = InceptionV3FID.from_torch(w, device=self.device)
        else:
            logging.warning("--fid_stats without --inception_weights: scoring with a seeded random-init Inception — "
                            "comparable only to stats from the same random net, NOT canonical FID")
            net = InceptionV3FID.random(device=self.device)
        t0 = time.time()
        mu1, s1 = fid_eval.compute_statistics_of_path(args.fid_stats, net.extract, device=self.device)
        mu2, s2 = fid_eval.sharded_statistics(fid_eval._iter_image_dir(args.image_folder, 256), net.extract,
                                              mesh=make_mesh(), device=self.device)
        n_gen = sum(len(glob.glob(os.path.join(args.image_folder, f"*.{ext}"))) for ext in fid_eval.IMAGE_EXTENSIONS)
        fid = fid_eval.frechet_smoke_safe(mu2, s2, mu1, s1, n_gen)
        logging.info(f"FID({args.image_folder} vs {args.fid_stats}) = {fid:.4f} (n={n_gen}, scored in "
                     f"{time.time() - t0:.1f}s)")
        if self.rank == 0:
            print(f"FID: {fid:.4f}")
        return fid

    # ------------------------------------------------------------------
    # calibration pipeline
    # ------------------------------------------------------------------

    def generate_calibrate_set(self, params, qunet, qstates, seq, num_calibrate_set=16):
        """FP-teacher trajectory -> calibration images by args.calib_t_mode;
        returns (images, the trajectory's model inputs [S, n, H, W, C])."""
        args = self.args
        t_mode = args.calib_t_mode
        logging.info(f"creating calibration set, t_mode={t_mode}")
        n = min(num_calibrate_set, 16)
        x, kw = self.randomness("calibration", self._image_shape(n))
        with torch.no_grad():
            _, traj, _ = self._timed("teacher", lambda: ddim_sample(
                lambda xt, t, i: unet_apply(params, self.ucfg, xt, t), x, seq, self.betas, eta=args.eta,
                keep_trajectory=True, **kw))
        xs_full = torch.cat([x[None], traj])
        z = self.randomness("calibration t", (n,))[0] if t_mode == "random" else None
        imgs, t_sel, self.sample_count = select_calibration_images(
            xs_full, t_mode, num_steps=len(list(seq)), normals=z, qstates=qstates, sample_count=self.sample_count,
            sample_weight=args.sample_weight)
        self.timestep_select = t_sel
        if t_sel is not None:
            logging.info(f"active timestep selection chose step {int(t_sel)}")
        return imgs, xs_full[:-1]

    def _calib_cache_path(self):
        """--calib_cache: a path, or 'auto' -> <log_path>/calib_cache.npz."""
        cc = getattr(self.args, "calib_cache", None)
        if not cc:
            return None
        if cc == "auto":
            log_path = getattr(self.args, "log_path", None)
            return os.path.join(log_path, "calib_cache.npz") if log_path else None
        return cc

    def _teacher_eps_scan(self, params, seq, xs_inputs):
        """The FP32 teacher's eps at every step of the calibration trajectory [S, n, H, W, C]."""
        t_rev = np.asarray(list(seq))[::-1].astype(np.float32)
        with torch.no_grad():
            return self._timed("teacher eps", lambda: torch.stack([
                unet_apply(params, self.ucfg, xs_inputs[s],
                           torch.full((xs_inputs.shape[1],), float(t_rev[s]), device=xs_inputs.device))
                for s in range(xs_inputs.shape[0])]))

    def calibrate_model(self, params, qunet, qstates, seq, first: bool = True, collect_attn_ranges: bool = False,
                        compute_extras: bool = False):
        """Stage 1 (ranges) + the weight pass (with `compute_extras`) +
        stage 2 (--calibrate_attention, reference or teacher mode) + the
        fold refinement (--weight_refine) + stage 3
        (--mixed_precision_attention), with --calib_cache persistence.
        Returns (qstates, mp_states or None); the attention ranges and the
        weight extras land on `self`.

        Every rank calls it.  Over several ranks rank 0 calibrates (and
        reads or writes the cache) and the others take its result, so every
        rank serves one calibration and one process writes the file."""
        def run():
            return self._calibrate(params, qunet, qstates, seq, first, collect_attn_ranges, compute_extras)

        if self.world == 1:
            return run()
        from ..parallel.collectives import broadcast_object

        keys = ("attn_ranges", "weight_extras", "sample_count", "timestep_select")
        out = None
        if self.rank == 0:
            try:
                out = {"result": run(), **{k: getattr(self, k) for k in keys}}
            except Exception as e:  # the other ranks wait on the broadcast: hand them the failure
                broadcast_object({"error": f"{type(e).__name__}: {e}"}, self.device)
                raise
        out = broadcast_object(out, self.device)
        if "error" in out:
            raise RuntimeError(f"calibration failed on rank 0: {out['error']}")
        for k in keys:
            setattr(self, k, out[k])
        return out["result"]

    def _calibrate(self, params, qunet, qstates, seq, first, collect_attn_ranges, compute_extras):
        """`calibrate_model` in this process."""
        from ..quant.calib_cache import load_calibration, save_calibration

        args = self.args
        cache_path = self._calib_cache_path()
        if cache_path:
            hit = self._timed("calibration cache", lambda: load_calibration(
                cache_path, args, seq, model_sig=str(self.ucfg), device=self.device))
            if hit is not None:
                self.attn_ranges = hit["attn_ranges"]
                self.weight_extras = hit["weight_extras"]
                self.sample_count = hit["sample_count"]
                self.timestep_select = hit["timestep_select"]
                if getattr(args, "mixed_precision_attention", False):
                    logging.warning("calibration cache covers stages 1-2 + weight extras; "
                                    "stage-3 MP attention recalibrates fresh")
                    return self._calibrate_stage3(params, qunet, hit["qstates"], seq)
                return hit["qstates"], None

        imgs, xs_inputs = self.generate_calibrate_set(params, qunet, qstates, seq)
        if collect_attn_ranges:
            qstates, self.attn_ranges = self._timed("calibration", lambda: calibrate_ranges(
                qunet, params, qstates, xs_inputs, seq, first=first, return_attn_ranges=True))
        else:
            qstates = self._timed("calibration", lambda: calibrate_ranges(
                qunet, params, qstates, xs_inputs, seq, first=first))
        logging.info(f"stage-1 range calibration done in {self.timings['calibration']:.1f}s")
        weight_opt = getattr(args, "weight_opt", "adaround")
        if compute_extras and weight_opt != "off":
            # before stage 2, so that the teacher-matched objective optimizes through the serving fold
            from ..quant.adaround import compute_weight_extras

            self.weight_extras = self._timed("weight pass", lambda: compute_weight_extras(
                qunet, params, qstates, xs_inputs, seq, iters=int(getattr(args, "adaround_iters", 1000) or 1000),
                adaround_max_wbit=0 if weight_opt == "biascorr" else 6, bias_correct=True,
                method="gptq" if weight_opt == "gptq" else "adaround",
                rank1=bool(getattr(args, "shared_fold", False))))
            n_ar = sum(1 for e in self.weight_extras.values() if e.round_offset is not None)
            logging.info(f"weight pass ({weight_opt}) done in {self.timings['weight pass']:.1f}s: "
                         f"{n_ar} layers round-optimized, {len(self.weight_extras)} bias-corrected")
        eps_ref = None
        if args.calibrate_attention and getattr(args, "stage2_mode", "reference") == "teacher":
            from ..quant.calibrate import calibrate_teacher_matched

            eps_ref = self._teacher_eps_scan(params, seq, xs_inputs)
            extras = self.weight_extras
            fwd_params = params if extras else qunet.prepare_params(params)[0]
            qstates, losses = self._timed("stage 2", lambda: calibrate_teacher_matched(
                qunet, fwd_params, qstates, xs_inputs, eps_ref, seq,
                lr=float(getattr(args, "stage2_lr", 0.02) or 0.02),
                epochs=int(getattr(args, "calib_epochs", 1) or 1) * 4, serving_extras=extras,
                rank1=bool(extras) and bool(getattr(args, "shared_fold", False))))
            logging.info(f"stage-2 (teacher-matched{', serving-fold semantics' if extras else ''}) done in "
                         f"{self.timings['stage 2']:.1f}s ({len(losses)} optimizer steps; rel-eps first/last: "
                         f"{losses[0]:.4f} / {losses[-1]:.4f})")
        elif args.calibrate_attention:
            _, kw = self.randomness("stage2")
            qstates, losses = self._timed("stage 2", lambda: calibrate_differentiable(
                qunet, params, qstates, imgs, seq, self.betas, eta=args.eta,
                # the attention-focused stage weights its entropy term with --attention_loss_weight
                diff_loss_weight=getattr(args, "attention_loss_weight", args.diff_loss_weight),
                attention_focus=True, epochs=int(getattr(args, "calib_epochs", 1) or 1), **kw))
            logging.info(f"stage-2 attention calibration done in {self.timings['stage 2']:.1f}s ({len(losses)} "
                         f"optimizer steps; per-step loss at first/last timestep: {losses[0]:.1f} / "
                         f"{losses[-1]:.1f} — not comparable across timesteps)")
        refine_mode = getattr(args, "weight_refine", "off") or "off"
        if refine_mode != "off" and self.weight_extras:
            from ..quant.calibrate import refine_weight_extras

            if eps_ref is None:
                eps_ref = self._teacher_eps_scan(params, seq, xs_inputs)
            self.weight_extras, _ = self._timed("refinement", lambda: refine_weight_extras(
                qunet, params, qstates, self.weight_extras, xs_inputs, eps_ref, seq,
                per_step=(refine_mode == "perstep"), rank1=bool(getattr(args, "shared_fold", False))))
            logging.info(f"weight refinement ({refine_mode}) done in {self.timings['refinement']:.1f}s")
        if cache_path:
            save_calibration(cache_path, args, seq, qstates,
                             attn_ranges=self.attn_ranges if collect_attn_ranges else None,
                             weight_extras=self.weight_extras, sample_count=self.sample_count,
                             timestep_select=self.timestep_select, model_sig=str(self.ucfg))
        if getattr(args, "mixed_precision_attention", False):
            return self._calibrate_stage3(params, qunet, qstates, seq, imgs=imgs)
        return qstates, None

    def _calibrate_stage3(self, params, qunet, qstates, seq, imgs=None):
        """Stage-3 mixed-precision attention calibration (enhanced variant)."""
        if self.ucfg.attn_variant != "enhanced":
            logging.warning("--mixed_precision_attention requires --attn_variant enhanced; skipping stage 3")
            return qstates, None
        from ..quant.attention_mp import calibrate_mp_attention, init_mp_attention_state, make_logit_collector

        if imgs is None:
            imgs, _ = self.generate_calibrate_set(params, qunet, qstates, seq)
        t0 = time.perf_counter()
        collector = make_logit_collector(params, self.ucfg, imgs)
        probe_ts = [min(t, self.num_timesteps - 1) for t in (0, 250, 500, 750, 999)]
        states = {n: init_mp_attention_state(self.num_timesteps, self.device) for n in collector(probe_ts[0])}
        mp_states = calibrate_mp_attention(collector, states, base_bits=self.args.bitwidth, timesteps=probe_ts)
        logging.info(f"stage-3 mixed-precision attention calibration done in {time.perf_counter() - t0:.1f}s "
                     f"({len(mp_states)} attention layers)")
        return qstates, mp_states

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def _compute_dtype(self):
        return torch.bfloat16 if getattr(self.args, "compute_dtype", "float32") == "bfloat16" else None

    def _build_model(self, params, seq):
        """(apply, state, description): `apply(state, x, t, step_idx) -> eps`
        of the float model (--fp32 or bitwidth <= 0; "fp-bf16" at a bf16
        compute dtype) or the fake-quant model (with the stage-3 core where
        calibration made one)."""
        args = self.args
        cd = self._compute_dtype()
        ucfg = self.ucfg
        if getattr(args, "fp32", False) or args.bitwidth <= 0:
            def apply(state, xt, t, i):
                return unet_apply(state, ucfg, xt, t, compute_dtype=cd)

            return apply, (params if cd is None else cast_params(params, cd)), ("fp32" if cd is None else "fp-bf16")
        qunet = self._qunet()
        qstates = qunet.init_state(len(list(seq)), self.device)
        qstates, mp_states = self.calibrate_model(params, qunet, qstates, seq, first=True)
        qparams, _ = qunet.prepare_params(params, compute_dtype=cd)
        desc = f"W{args.bitwidth}A{getattr(args, 'a_bitwidth', None) or args.bitwidth}" + ("/bf16" if cd else "")
        if mp_states is not None:
            from ..quant.qunet import make_quant_conv_apply

            def apply(state, xt, t, i):
                qp, qs, mps = state
                ctx = {"mp_states": mps, "base_bits": args.bitwidth, "timestep": t[0].to(torch.int64)}
                ca = make_quant_conv_apply(qs, qunet.policy, i, mode="infer")
                return unet_apply(qp, qunet.cfg, xt, t, conv_apply=ca, compute_dtype=cd, attn_ctx=ctx)

            return apply, (qparams, qstates, mp_states), desc + "+mpattn"

        def apply(state, xt, t, i):
            qp, qs = state
            return qunet.apply(qp, qs, xt, t, i, compute_dtype=cd)

        return apply, (qparams, qstates), desc

    def _serving_sampler(self, params, seq):
        """The fused int8 serving sampler at the run's flags (calibrating
        first); returns (sampler, description).  What it was built from goes
        to `self.serving`."""
        args, config = self.args, self.config
        S = len(list(seq))
        qunet = self._qunet()
        qstates = qunet.init_state(S, self.device)
        attn_int8 = bool(getattr(args, "attn_int8", False))
        if attn_int8 and self.ucfg.attn_variant == "enhanced":
            logging.warning("--attn_int8 applies to the ddim attention variant only; enhanced serving runs the f32 "
                            "attention core")
            attn_int8 = False
        qstates, mp_states = self.calibrate_model(params, qunet, qstates, seq, first=True,
                                                  collect_attn_ranges=attn_int8, compute_extras=True)
        res_dtype = torch.bfloat16 if self._compute_dtype() is not None else torch.float32
        step_chunk = getattr(args, "step_chunk", None)
        shared_fold = bool(getattr(args, "shared_fold", False))
        pack = bool(getattr(args, "pack_int4", False))
        if shared_fold and step_chunk is not None:
            logging.warning("--shared_fold stores ONE step-shared int8 weight tensor (fold memory = params) — "
                            "dropping --step_chunk")
            step_chunk = None
        # fold-memory advisory: per-step folded int8 weights cost S x params bytes (halved by --pack_int4 at
        # w_bit <= 4; params alone with --shared_fold)
        n_par = count_params(params)
        fold_gb = (1 if shared_fold else S) * (n_par / 2 if (pack and args.bitwidth <= 4) else n_par) / 1e9
        if step_chunk is None and fold_gb > 8.0:
            logging.warning(f"unchunked fold needs ~{fold_gb:.1f} GB of folded int8 weights (S={S} x "
                            f"{n_par / 1e6:.0f}M params); consider --shared_fold (fold-once at any schedule), "
                            "--pack_int4 (2x at w<=4), or --step_chunk")
        elif step_chunk is not None and fold_gb < 4.0:
            logging.info(f"folded weights are only ~{fold_gb:.1f} GB — dropping --step_chunk (fold-once) is "
                         "typically faster here")
        # superbatch mode (chunked only): the batch advances micro_batch images at a time through each chunk
        micro = getattr(config.sampling, "batch_size", 64) if step_chunk and getattr(args, "superbatch", None) else None
        use_ddpm = args.sample_type == "ddpm_noisy"
        kwargs = dict(eta=args.eta, step_chunk=step_chunk, micro_batch=micro, residual_dtype=res_dtype,
                      attn_int8=attn_int8, attn_ranges=self.attn_ranges if attn_int8 else None,
                      weight_extras=self.weight_extras, pack_int4=pack, rank1=shared_fold,
                      update="ddpm" if use_ddpm else "ddim", mp_states=mp_states, mp_base_bits=args.bitwidth)
        from ..quant.int8_serving import serving_ddim_sampler

        sampler = self._timed("fold", lambda: serving_ddim_sampler(qunet, params, qstates, seq, self.betas, **kwargs))
        self.serving = dict(sampler=sampler, qunet=qunet, params=params, qstates=qstates, seq=seq, kwargs=kwargs)
        desc = (f"serving-int8 W{args.bitwidth}A{getattr(args, 'a_bitwidth', None) or args.bitwidth}"
                + ("/ddpm" if use_ddpm else "") + ("/bf16res" if res_dtype == torch.bfloat16 else "")
                + ("/attn-int8" if attn_int8 else "") + ("/mpattn" if mp_states else "")
                + (f"/{getattr(args, 'weight_opt', 'adaround')}" if self.weight_extras else "")
                + ("/shared-fold" if shared_fold else "") + ("/int4-packed" if pack else ""))
        return sampler, desc

    def _float_sampler(self, apply, mstate, seq):
        """`run(x, **randomness keywords)` of the DDIM (or --sample_type ddpm_noisy) sampler over `apply`."""
        args = self.args

        def model(xt, t, i):
            return apply(mstate, xt, t, i)

        if args.sample_type == "ddpm_noisy":
            return lambda x, **kw: ddpm_sample(model, x, seq, self.betas, **kw)
        return lambda x, **kw: ddim_sample(model, x, seq, self.betas, eta=args.eta, **kw)

    def sample(self):
        """Sample as the flags say (see the module's docstring).  Over
        several ranks each batch of the --fid loop and of the plain sample
        splits over the data ranks (rounded to their count as JAX's runner
        rounds it); every rank draws the whole batch's noise and keeps its
        slice, the images are gathered back, and rank 0 writes the PNGs, so
        the files are those of one rank.  --interpolation and --sequence
        stay on rank 0, unsharded, as in JAX."""
        args, config = self.args, self.config
        self.timings = {}
        seq = self.make_seq()
        params = self._timed("load", self._load_params)
        serving = (getattr(args, "execution", "fake_quant") == "serving" and not getattr(args, "fp32", False)
                   and args.bitwidth > 0)
        apply = mstate = None
        if serving:
            run, desc = self._serving_sampler(params, seq)
        else:
            apply, mstate, desc = self._build_model(params, seq)
            run = self._float_sampler(apply, mstate, seq)
        logging.info(f"sampling with {len(list(seq))} steps, model={desc}")
        mesh = make_mesh()
        n_dev = mesh.size
        noised = args.sample_type == "ddpm_noisy" or args.eta > 0

        def dispatch(stream, n, index=0):
            """Batch `index` of `stream`: n images, split over the data ranks
            (every rank draws the whole batch's noise and keeps its slice),
            gathered back whole on every rank."""
            x, kw = self.randomness(stream, self._image_shape(n), index)
            if n_dev > 1:
                from ..diffusion.sampling import draw_noise
                from ..parallel import shard_batch
                from ..parallel.collectives import all_gather

                if noised:  # the sampler's per-step draws, whole, in its order; then this rank's slice
                    noise = kw["noise"] if "noise" in kw else [draw_noise(i, x, kw["generator"])
                                                               for i in range(len(list(seq)))]
                    kw = {"noise": [shard_batch(mesh, torch.as_tensor(z, device=x.device)) for z in noise]}
                x = shard_batch(mesh, x)
            with torch.no_grad():
                out = run(x, **kw)
            return out if n_dev == 1 else torch.cat(all_gather(out, mesh.groups["data"]))

        os.makedirs(args.image_folder, exist_ok=True)
        if args.fid:
            n = self._fid(dispatch, serving, n_dev)
            if getattr(args, "fid_stats", None):  # the folder is scored once it is written
                self.fid_score = self._timed("fid score", self._score_fid)
            return n
        if (args.interpolation or args.sequence) and serving:
            # the trajectory paths run on the fake-quant model (they need the generic `apply`); every rank
            # takes part in its calibration
            apply, mstate, _ = self._build_model(params, seq)
        if args.interpolation:
            if self.rank:  # unsharded, as in JAX: rank 0 draws and writes the grid
                return None
            return self._interpolation(apply, mstate, seq)
        n = args.num_samples or 64
        if args.sequence and self.rank == 0:  # unsharded, as in JAX
            x, kw = self.randomness("sample", self._image_shape(n))
            with torch.no_grad():
                _, traj, _ = ddim_sample(lambda xt, t, i: apply(mstate, xt, t, i), x, seq, self.betas, eta=args.eta,
                                         keep_trajectory=True, **kw)
            traj = traj.cpu()
            stride = max(1, traj.shape[0] // 10)
            for s in range(0, traj.shape[0], stride):
                save_image_grid(inverse_data_transform(config, traj[s]).numpy(),
                                os.path.join(args.image_folder, f"seq_step{s}.png"))
        n = max(n_dev, n - n % n_dev)
        out = self._timed("sampling", lambda: dispatch("sample", n))
        if self.rank == 0:
            imgs = self._timed("png", lambda: self._save_samples(inverse_data_transform(config, out).cpu().numpy()))
            logging.info(f"saved {imgs} samples to {args.image_folder}")

    def _save_samples(self, imgs):
        for i in range(imgs.shape[0]):
            save_image(imgs[i], os.path.join(self.args.image_folder, f"sample_{i}.png"))
        save_image_grid(imgs, os.path.join(self.args.image_folder, "grid.png"))
        return imgs.shape[0]

    def _fid(self, dispatch, serving, n_dev: int = 1):
        """The --fid bulk loop: `<id>.png` files up to --num_samples (default
        50000), batch b from the stream of index b, resuming at the first
        missing id aligned down to the batch grid (the interrupted batch is
        generated again, byte-identical).  The batch rounds down to a
        multiple of the `n_dev` data ranks, and the last one generates the
        images still missing rounded up to one (it keeps those it needs), as
        JAX's runner does; rank 0 writes.  Batch k's PNGs are encoded on a
        background thread while the host launches batch k+1."""
        args, config = self.args, self.config
        total = args.num_samples if args.num_samples else 50000
        batch = getattr(config.sampling, "batch_size", 256)
        if serving and getattr(args, "superbatch", None):
            if getattr(args, "step_chunk", None):
                # chunked mode: a superbatch per sampler pass, so the per-chunk fold amortizes over it
                batch = max(batch, int(args.superbatch))
            else:
                logging.warning("--superbatch requires --step_chunk; ignoring")
        batch = max(n_dev, batch - batch % n_dev)
        img_id = _contiguous_prefix(args.image_folder)
        img_id -= img_id % batch
        start = img_id
        if start:
            logging.info(f"resuming: {start} images already in {args.image_folder}")
        png_s = [0.0]
        main = self.rank == 0

        def write(imgs, iid):
            t0 = time.perf_counter()
            write_png_batch(imgs, args.image_folder, iid)
            png_s[0] += time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as writer:
            pending = None
            for iid in range(img_id, total, batch):
                n = min(batch, total - iid)
                n_gen = max(n_dev, n + (-n) % n_dev)
                out = self._timed("sampling", lambda: inverse_transform_uint8(
                    config, dispatch("fid", n_gen, iid // batch)[:n]))
                imgs = out.cpu().numpy()
                if pending is not None:
                    pending.result()
                if main:
                    pending = writer.submit(write, imgs, iid)
                rate = (iid + n - start) / max(1e-9, time.perf_counter() - t0)
                logging.info(f"{iid + n}/{total} images ({rate:.1f} img/s, {rate / n_dev:.1f} img/s/device)")
            t_wait = time.perf_counter()
            if pending is not None:
                pending.result()
        if n_dev > 1:  # the folder is whole before any rank reads it (--fid_stats)
            import torch.distributed as dist

            dist.barrier()
        self.timings["png"] = png_s[0]
        self.timings["png wait"] = time.perf_counter() - t_wait
        self.fid_images = total - start
        return self.fid_images

    def _interpolation(self, apply, mstate, seq):
        """Spherical interpolation in noise space between two draws, 11 points, one grid."""
        args, config = self.args, self.config
        z, kw = self.randomness("interpolation", self._image_shape(2))
        z1, z2 = z[0:1], z[1:2]
        alphas = np.linspace(0.0, 1.0, 11, dtype=np.float32)
        theta = torch.arccos(torch.clamp((z1 * z2).sum() / (torch.linalg.norm(z1) * torch.linalg.norm(z2)), -1, 1))
        zs = torch.cat([(torch.sin((1 - float(a)) * theta) * z1 + torch.sin(float(a) * theta) * z2) / torch.sin(theta)
                        for a in alphas])
        with torch.no_grad():
            out = ddim_sample(lambda xt, t, i: apply(mstate, xt, t, i), zs, seq, self.betas, eta=args.eta, **kw)
        save_image_grid(inverse_data_transform(config, out).cpu().numpy(),
                        os.path.join(args.image_folder, "interpolation.png"), nrow=len(alphas))
        logging.info(f"saved interpolation grid to {args.image_folder}")
